"""Port parity: the port's Mixtral against the flax Mixtral on converted
weights.

``mixtral_tiny`` (2 layers, hidden 64, 4 experts, top-2) in f32, B=4,
S=32, both dispatch paths: ``MoELayer`` outputs within 2e-5
(``tests/test_mixtral_decode.py``'s ATOL), aux within 1e-6 and drop
counts equal to JAX's exactly (above 0 at capacity_factor 0.25, 0 at
capacity_factor = E); model logits within 2e-5, the loss and every
parameter's gradient within 5e-4 (``tests/test_torch_llama.py``); the
port's two paths against each other at ``tests/test_moe_dispatch.py``'s
tolerances (forward 1e-5, aux 1e-6, grads atol 2e-6 / rtol 1e-4); three
``Trainer`` steps with ``make_moe_lm_loss`` against the JAX ``Trainer``
within 5e-4; bf16 logits judged against the logits' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import mixtral as jmix
from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
from tf_operator_tpu.parallel.sharding import MOE_RULES
from tf_operator_tpu.train import trainer as jtr
from tf_operator_tpu_torch.models import mixtral as tmix
from tf_operator_tpu_torch.models.convert import (
    mixtral_params_from_flax,
    mixtral_params_to_flax,
)
from tf_operator_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.compute

B, S = 4, 32
ATOL = 2e-5
AUX_TOL = 1e-6
GRAD_TOL = 5e-4
DISPATCH = ["einsum", "gather"]
N_EXPERTS = jmix.mixtral_tiny().n_experts


def configs(dtype="float32", **fields):
    """The same config for both packages (JAX dtype, torch dtype)."""
    j = dataclasses.replace(jmix.mixtral_tiny(), dtype=getattr(jnp, dtype),
                            **fields)
    t = dataclasses.replace(tmix.mixtral_tiny(),
                            dtype=getattr(torch, dtype), **fields)
    return j, t


def tokens(seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1))


def build(dtype="float32", seed=0, **fields):
    """flax params from a seed, and the port's model loaded with them."""
    jcfg, tcfg = configs(dtype, **fields)
    jmodel = jmix.Mixtral(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tmix.Mixtral(tcfg, device="cpu")
    tmodel.load_state_dict(mixtral_params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def f32():
    return build()


def test_bridge_round_trips(f32):
    _, params, tmodel = f32
    back = mixtral_params_to_flax(tmodel.state_dict(), tmodel.cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_bridge_raises_on_leftover_and_missing(f32):
    _, params, tmodel = f32
    blocks = dict(params["blocks"], mlp={"gate": {"kernel": np.zeros(3)}})
    with pytest.raises(KeyError, match="left over"):
        mixtral_params_from_flax(dict(params, blocks=blocks), tmodel.cfg)
    moe = {k: v for k, v in params["blocks"]["moe"].items() if k != "w_up"}
    with pytest.raises(KeyError, match="w_up"):
        mixtral_params_from_flax(
            dict(params, blocks=dict(params["blocks"], moe=moe)), tmodel.cfg)


def test_param_axes_match_jax(f32):
    """Every port parameter's logical axes are the flax leaf's without the
    scan's "layers" axis, reversed where the port stores a Dense weight
    [out, in]."""
    _, params, tmodel = f32
    flat = {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    by_port = {}
    for path, leaf in flat.items():
        axes = jmix.param_logical_axes(path, leaf)
        if path[0] == "blocks":
            assert axes[0] == "layers", path
            axes = axes[1:]
        if path[-1] == "kernel":
            axes = axes[::-1]
        by_port[path] = axes
    assert len(list(tmodel.parameters())) == tmodel.cfg.n_layers * (
        len(by_port) - 3) + 3
    for name, param in tmodel.named_parameters():
        got = tmix.param_logical_axes(name, param)
        parts = name.split(".")
        if parts[0] == "layers":
            parts = ["blocks"] + parts[2:]
        leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
        if parts[0] == "embed_tokens":
            leaf = "embedding"
        key = tuple(parts[:-1] + [leaf])
        assert got == tuple(by_port[key]), (name, got, by_port[key])


# ---------------------------------------------------------------------------
# MoELayer alone
# ---------------------------------------------------------------------------

def moe_pair(dispatch, **fields):
    """A flax MoELayer's params and the port's layer loaded with them."""
    jcfg, tcfg = configs(dispatch=dispatch, **fields)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                     (2, 32, jcfg.hidden), jnp.float32))
    jlayer = jmix.MoELayer(jcfg)
    params = jax.tree.map(np.asarray, jlayer.init(
        jax.random.PRNGKey(4), jnp.asarray(x))["params"])
    tlayer = tmix.MoELayer(tcfg, "cpu", torch.Generator().manual_seed(0))
    tlayer.load_state_dict({
        "router.weight": torch.tensor(params["router"]["kernel"].T.copy()),
        **{n: torch.tensor(params[n]) for n in ("w_gate", "w_up",
                                                "w_down")}})
    return jlayer, params, tlayer, x


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("capacity_factor, drops", [
    (1.25, None), (0.25, True), (float(N_EXPERTS), False)])
def test_moe_layer_matches_jax(dispatch, capacity_factor, drops):
    jlayer, params, tlayer, x = moe_pair(dispatch,
                                         capacity_factor=capacity_factor)
    (want, want_aux), inter = jlayer.apply({"params": params},
                                           jnp.asarray(x),
                                           mutable=["intermediates"])
    want_dropped = int(inter["intermediates"]["dropped_assignments"][0])
    with torch.no_grad():
        got, aux = tlayer(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert abs(aux.item() - float(want_aux)) < AUX_TOL
    dropped = int(tlayer.dropped_assignments)
    assert dropped == want_dropped
    if drops is not None:
        assert (dropped > 0) == drops, dropped


def test_moe_layer_top_k_has_no_tie_at_the_kth_place():
    """The drop counts above compare routing decisions: at these inputs no
    router probability ties the k-th largest of its token."""
    _, _, tlayer, x = moe_pair("einsum")
    with torch.no_grad():
        probs = torch.softmax(tlayer.router(torch.tensor(x).reshape(
            -1, x.shape[-1])), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    k = tlayer.cfg.experts_per_token
    assert (top[:, k - 1] - top[:, k]).min() > 1e-6


def test_unknown_dispatch_raises():
    _, tcfg = configs(dispatch="scatter_gather_v2")
    with pytest.raises(ValueError, match="dispatch"):
        tmix.Mixtral(tcfg, device="cpu")


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", DISPATCH)
def test_logits_and_aux_match_jax(dispatch, f32):
    _, params, tmodel = f32
    jcfg, tcfg = configs(dispatch=dispatch)
    toks = tokens()[:, :-1]
    want, want_aux = jmix.Mixtral(jcfg).apply({"params": params},
                                              jnp.asarray(toks))
    model = tmix.Mixtral(tcfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        got, aux = model(torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert abs(aux.item() - float(want_aux)) < AUX_TOL
    # The default capacity drops at these inputs, so the logits cover
    # dropped assignments.
    assert sum(int(layer.moe.dropped_assignments)
               for layer in model.layers) > 0


def _torch_grads(model, toks, weight):
    model.zero_grad(set_to_none=True)
    loss = tmix.make_moe_lm_loss(weight)(model, {"inputs": torch.tensor(toks)})
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_loss_and_every_grad_match_jax(dispatch, f32):
    _, params, tmodel = f32
    jcfg, tcfg = configs(dispatch=dispatch)
    jmodel = jmix.Mixtral(jcfg)
    loss_fn = jmix.make_moe_lm_loss(jcfg.aux_loss_weight)
    toks = tokens(1)

    def loss_of(p):
        return loss_fn(p, {}, {"inputs": jnp.asarray(toks)},
                       jmodel.apply)[0]

    j_loss, j_grads = jax.value_and_grad(loss_of)(params)
    want = mixtral_params_from_flax(jax.tree.map(np.asarray, j_grads), tcfg)
    model = tmix.Mixtral(tcfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    t_loss, got = _torch_grads(model, toks, tcfg.aux_loss_weight)
    np.testing.assert_allclose(t_loss, float(j_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_dispatch_paths_agree(f32):
    """The port's einsum and gather paths on the same weights:
    tests/test_moe_dispatch.py's tolerances."""
    _, _, tmodel = f32
    models = {}
    for dispatch in DISPATCH:
        models[dispatch] = tmix.Mixtral(dataclasses.replace(
            tmodel.cfg, dispatch=dispatch), device="cpu")
        models[dispatch].load_state_dict(tmodel.state_dict())
    toks = tokens(2)
    with torch.no_grad():
        (le, ae), (lg, ag) = (models[d](torch.tensor(toks[:, :-1]))
                              for d in DISPATCH)
    np.testing.assert_allclose(le.numpy(), lg.numpy(), atol=1e-5, rtol=1e-5)
    assert abs(ae.item() - ag.item()) < AUX_TOL
    drops = {d: [int(layer.moe.dropped_assignments)
                 for layer in models[d].layers] for d in DISPATCH}
    assert drops["einsum"] == drops["gather"]
    grads = {d: _torch_grads(models[d], toks, 0.02)[1] for d in DISPATCH}
    for name, g in grads["einsum"].items():
        torch.testing.assert_close(grads["gather"][name], g, atol=2e-6,
                                   rtol=1e-4, msg=name)


def test_remat_full_matches_no_remat(f32):
    _, _, tmodel = f32
    remat = tmix.Mixtral(dataclasses.replace(tmodel.cfg, remat=True),
                         device="cpu")
    remat.load_state_dict(tmodel.state_dict())
    toks = tokens(3)
    loss_a, grads_a = _torch_grads(tmodel, toks, 0.02)
    loss_b, grads_b = _torch_grads(remat, toks, 0.02)
    assert loss_a == pytest.approx(loss_b, abs=1e-6)
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], atol=1e-6,
                                   rtol=1e-6, msg=name)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_trainer_steps_match_jax(dispatch):
    """Three AdamW steps of make_moe_lm_loss: loss, grad norm and every
    parameter against the JAX Trainer on a one-device mesh."""
    jcfg, tcfg = configs(dispatch=dispatch)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtrainer = jtr.Trainer(model=jmix.Mixtral(jcfg),
                           param_axes_fn=jmix.param_logical_axes,
                           rules=MOE_RULES, mesh=mesh,
                           optimizer=optax.adamw(3e-4),
                           loss_fn=jmix.make_moe_lm_loss(
                               jcfg.aux_loss_weight))
    sample = {"inputs": jnp.zeros((B, S + 1), jnp.int32)}
    jstate, shardings = jtrainer.init(jax.random.PRNGKey(0), sample)
    jstep = jtrainer.make_train_step(shardings, sample)

    model = tmix.Mixtral(tcfg, device="cpu")
    model.load_state_dict(mixtral_params_from_flax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    ttrainer = ttr.Trainer(model=model, optimizer=ttr.adamw(3e-4),
                           loss_fn=tmix.make_moe_lm_loss(
                               tcfg.aux_loss_weight), device="cpu")
    tstate = ttrainer.init()
    tstep = ttrainer.make_train_step()
    data = np.random.default_rng(0)
    for i in range(3):
        toks = data.integers(0, tcfg.vocab_size, (B, S + 1))
        jstate, jm = jstep(jstate, {"inputs": jnp.asarray(toks, jnp.int32)})
        tstate, tm = tstep(tstate, {"inputs": toks})
        assert tm["step"] == int(jm["step"]) == i
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    want = mixtral_params_from_flax(jax.tree.map(np.asarray, jstate.params),
                                    tcfg)
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(),
                                   want[name].numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_bf16_logits_match_jax(f32):
    """bf16 logits against JAX's, judged against the logits' scale (as
    tests/test_torch_llama.py: XLA's CPU bf16 ``logistic`` in silu is not
    correctly rounded), and no further from the f32 model than JAX's own
    bf16 run (x1.25)."""
    jmodel, params, tmodel = build(dtype="bfloat16")
    jf32, params_f32, _ = f32
    toks = tokens(3)[:, :-1]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks))[0],
                      np.float32)
    truth = np.asarray(jf32.apply({"params": params_f32},
                                  jnp.asarray(toks))[0])
    with torch.no_grad():
        got, _ = tmodel(torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= 2e-2
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert rel(got, truth) <= 1.25 * rel(want, truth)


def test_mixtral_8x7b_widths():
    want = jmix.mixtral_8x7b()
    got = tmix.mixtral_8x7b()
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.bfloat16
    tiny_j, tiny_t = jmix.mixtral_tiny(), tmix.mixtral_tiny()
    for f in dataclasses.fields(tiny_t):
        if f.name != "dtype":
            assert getattr(tiny_t, f.name) == getattr(tiny_j, f.name), f.name
