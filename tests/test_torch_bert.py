"""Port parity: the port's BERT, its LayerNorm and biased Dense against the
flax ones on converted weights.

- ``LayerNorm`` against flax's ``nn.LayerNorm`` in f32 (outputs 2e-5,
  gradients 1e-5: ``TPUBatchNorm``'s limits, ``tests/test_torch_resnet.py``)
  and in bf16 (one bf16 rounding of the outputs' scale);
  ``torch.nn.LayerNorm`` (eps 1e-5, two-pass variance) misses them on
  inputs of an embedding's scale;
- ``Bert(bert_tiny)`` in f32 against the JAX ``Bert`` at S=40 <
  ``max_seq_len``: logits within 2e-5 without and with an ``attn_mask``
  (one row padded at its tail, one row all padding); the MLM loss and every
  parameter's gradient within 5e-4; remat on and off within 1e-6; bf16
  logits against the logits' scale (2e-2) and no further from the f32
  model than JAX's bf16 run is;
- ``param_logical_axes`` equal to JAX's for every leaf, and the weight
  bridge's round trip exact;
- three ``Trainer`` steps of adamw(1e-4) with ``mlm_loss`` against the JAX
  ``Trainer``: losses and parameters within 5e-4;
- the port of ``test_moe_bert_ckpt.py::test_bert_mlm_learns``, and the
  payload on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tf_operator_tpu.models import bert as jbert
from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
from tf_operator_tpu.parallel.sharding import LLAMA_RULES
from tf_operator_tpu.train import trainer as jtr
from tf_operator_tpu_torch.models import bert as tbert
from tf_operator_tpu_torch.models.convert import (
    bert_params_from_flax,
    bert_params_to_flax,
)
from tf_operator_tpu_torch.ops.layers import LayerNorm, gelu, layer_norm
from tf_operator_tpu_torch.train import trainer as ttr

pytestmark = pytest.mark.compute

B, S = 3, 40
LN_TOL, LN_GRAD_TOL = 2e-5, 1e-5
LOGITS_TOL = 2e-5
GRAD_TOL = 5e-4
TRAIN_TOL = 5e-4
REMAT_TOL = 1e-6
STEPS = 3
LR = 1e-4


def configs(dtype="float32"):
    j = dataclasses.replace(jbert.bert_tiny(), dtype=getattr(jnp, dtype))
    t = dataclasses.replace(tbert.bert_tiny(), dtype=getattr(torch, dtype))
    return j, t


def mlm_batch(seed=0, b=B, s=S, vocab=256, padded=False):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, vocab, (b, s))
    mask = rng.random((b, s)) < 0.15
    batch = {"inputs": np.where(mask, 3, targets), "targets": targets,
             "mask": mask.astype(np.float32)}
    if padded:
        attn = np.ones((b, s), np.int32)
        attn[1, s // 2:] = 0        # a row padded at its tail
        attn[2] = 0                 # a row all padding: uniform softmax
        batch["attn_mask"] = attn
    return batch


def randomized_norms_and_biases(params, seed=0):
    """``params`` with every bias and LayerNorm scale drawn at random:
    flax makes them 0 and 1, on which a bias or scale in the wrong place
    would not show."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def build(dtype="float32", seed=0):
    """flax params from a seed (norms and biases drawn at random), and the
    port's model loaded with them."""
    jcfg, tcfg = configs(dtype)
    jmodel = jbert.Bert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = randomized_norms_and_biases(jax.tree.map(np.asarray, params))
    tmodel = tbert.Bert(tcfg, device="cpu")
    tmodel.load_state_dict(bert_params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def f32():
    return build()


def jax_compiled(fn, *args):
    """``fn(*args)`` compiled with excess precision off, so XLA rounds
    each bf16 op as the port does."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---------------------------------------------------------------------------
# LayerNorm and gelu
# ---------------------------------------------------------------------------

def ln_inputs(scale, seed=0, shape=(4, 24, 64)):
    """Activations of ``scale`` around a mean offset, and a random
    LayerNorm scale and bias."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + 0.5 * scale).astype(np.float32)
    c = shape[-1]
    return x, {"scale": (1 + 0.3 * rng.standard_normal(c)).astype(np.float32),
               "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}


def flax_ln(x, leaves, dtype, cotangent=None):
    """flax LayerNorm(dtype, param_dtype=f32): output, and the gradients
    of sum(out * cotangent) in x, scale and bias."""
    m = fnn.LayerNorm(dtype=getattr(jnp, dtype), param_dtype=jnp.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))

    def run(p, xx):
        return m.apply({"params": p}, xx)

    y = jax_compiled(run, leaves, xj)
    if cotangent is None:
        return np.asarray(y, np.float32), None
    dp, dx = jax.grad(lambda p, xx: (run(p, xx) * cotangent).sum(),
                      argnums=(0, 1))(leaves, xj)
    return np.asarray(y, np.float32), {"x": np.asarray(dx), **jax.tree.map(
        np.asarray, dp)}


def port_ln(x, leaves, dtype, cotangent=None, module=None):
    m = module or LayerNorm(x.shape[-1], getattr(torch, dtype), device="cpu")
    if module is None:
        m.load_state_dict({k: torch.tensor(v) for k, v in leaves.items()})
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    y = m(xt)
    if cotangent is None:
        return y.detach().float().numpy(), None
    (y * torch.tensor(cotangent)).sum().backward()
    named = dict(m.named_parameters())
    grads = {"x": xt.grad.numpy(),
             "scale": named["weight" if "weight" in named
                            else "scale"].grad.numpy(),
             "bias": named["bias"].grad.numpy()}
    return y.detach().float().numpy(), grads


def assert_ln_close(got, want):
    (y, grads), (y_want, grads_want) = got, want
    np.testing.assert_allclose(y, y_want, atol=LN_TOL, rtol=LN_TOL)
    for name, g in grads_want.items():
        np.testing.assert_allclose(grads[name], g, atol=LN_GRAD_TOL,
                                   rtol=LN_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("scale", [768 ** -0.5, 1.0, 30.0])
def test_layer_norm_matches_flax_f32(scale):
    """Activations of an embedding's scale (BERT-base's token embeddings
    draw at 768^-½), of a residual stream's, and large ones."""
    x, leaves = ln_inputs(scale)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    assert_ln_close(port_ln(x, leaves, "float32", cot),
                    flax_ln(x, leaves, "float32", cot))


@pytest.mark.parametrize("scale", [768 ** -0.5, 1.0])
def test_layer_norm_matches_flax_bf16(scale):
    """bf16 in and out, statistics and affine in f32: within one bf16
    rounding (2**-8 relative) of the outputs' scale."""
    x, leaves = ln_inputs(scale, seed=2)
    (y, _), (y_want, _) = (port_ln(x, leaves, "bfloat16"),
                           flax_ln(x, leaves, "bfloat16"))
    assert np.abs(y - y_want).max() <= 2 ** -8 * np.abs(y_want).max()
    # Most elements round alike.
    assert (y == y_want).mean() > 0.95


def test_torch_layer_norm_fails_the_tolerance():
    """torch.nn.LayerNorm with the same scale and bias (its eps 1e-5 and
    two-pass variance) misses flax's LayerNorm on embedding-scale
    activations; the port's layer passes the same comparison."""
    x, leaves = ln_inputs(768 ** -0.5)
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    want = flax_ln(x, leaves, "float32", cot)
    ln = torch.nn.LayerNorm(x.shape[-1])
    ln.load_state_dict({"weight": torch.tensor(leaves["scale"]),
                        "bias": torch.tensor(leaves["bias"])})
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        assert_ln_close(port_ln(x, leaves, "float32", cot, module=ln), want)
    assert_ln_close(port_ln(x, leaves, "float32", cot), want)


def test_layer_norm_function_casts_at_the_end():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    out = layer_norm(x, torch.ones(8), torch.zeros(8), dtype=torch.float32)
    assert out.dtype == torch.float32
    assert layer_norm(x, torch.ones(8), torch.zeros(8)).dtype == x.dtype


def test_gelu_tanh_matches_jax():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(gelu(torch.tensor(x)).numpy(), want,
                               atol=1e-6, rtol=1e-6)
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    np.testing.assert_allclose(gelu(torch.tensor(x), False).numpy(), exact,
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_config_fields_match_jax():
    for make in ("bert_base", "bert_tiny"):
        want, got = getattr(jbert, make)(), getattr(tbert, make)()
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.bfloat16


def test_bridge_round_trips(f32):
    _, params, tmodel = f32
    back = bert_params_to_flax(tmodel.state_dict(), tmodel.cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_bridge_raises_on_leftover_and_missing(f32):
    _, params, tmodel = f32
    extra = dict(params, stray={"kernel": np.zeros(3)})
    with pytest.raises(KeyError, match="left over"):
        bert_params_from_flax(extra, tmodel.cfg)
    missing = {k: v for k, v in params.items() if k != "mlm_ln"}
    with pytest.raises(KeyError, match="mlm_ln"):
        bert_params_from_flax(missing, tmodel.cfg)


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "mask"])
def test_logits_match_jax(f32, padded):
    jmodel, params, tmodel = f32
    batch = mlm_batch(padded=padded)
    attn = batch.get("attn_mask")
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(batch["inputs"]),
        None if attn is None else jnp.asarray(attn)))
    with torch.no_grad():
        got = tmodel(torch.tensor(batch["inputs"]),
                     None if attn is None else torch.tensor(attn))
    assert got.shape == (B, S, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def _torch_grads(tmodel, batch):
    tmodel.zero_grad(set_to_none=True)
    loss = tbert.mlm_loss(tmodel, {k: torch.tensor(v)
                                   for k, v in batch.items()})
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tmodel.named_parameters()}


def test_loss_and_every_grad_match_jax(f32):
    jmodel, params, tmodel = f32
    batch = mlm_batch(1, padded=True)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jbert.mlm_loss(p, None, jbatch, jmodel.apply),
        has_aux=True)(params)
    want = bert_params_from_flax(jax.tree.map(np.asarray, j_grads),
                                 tmodel.cfg)
    t_loss, got = _torch_grads(tmodel, batch)
    np.testing.assert_allclose(t_loss, float(j_loss), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    # The padded row's positions still train through the MLM head.
    assert got["layers.0.attn.wq.bias"].abs().sum() > 0


def test_remat_matches_no_remat(f32):
    _, _, tmodel = f32
    remat = tbert.Bert(dataclasses.replace(tmodel.cfg, remat=True),
                       device="cpu")
    remat.load_state_dict(tmodel.state_dict())
    batch = mlm_batch(2, padded=True)
    loss_a, grads_a = _torch_grads(tmodel, batch)
    loss_b, grads_b = _torch_grads(remat, batch)
    assert loss_a == pytest.approx(loss_b, abs=REMAT_TOL)
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name],
                                   atol=REMAT_TOL, rtol=REMAT_TOL, msg=name)


def test_bf16_logits_match_jax(f32):
    """bf16 logits within 2e-2 of JAX's (excess precision off), against
    the logits' scale, and no further from the f32 model than JAX's own
    bf16 run is."""
    jmodel, params, tmodel = build("bfloat16")
    jf32, params_f32, _ = f32
    toks = mlm_batch(3)["inputs"]
    want = np.asarray(jax_compiled(
        lambda p, t: jmodel.apply({"params": p}, t), params,
        jnp.asarray(toks)), np.float32)
    truth = np.asarray(jf32.apply({"params": params_f32}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= 2e-2
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert rel(got, truth) <= 1.25 * rel(want, truth)


def test_param_logical_axes_match_jax(f32):
    """For every flax leaf, the port's axes of its parameter are JAX's
    (less the scanned axis, and reversed for a Dense kernel)."""
    _, params, tmodel = f32
    named = dict(tmodel.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    seen = set()
    for path, leaf in leaves:
        keys = tuple(p.key for p in path)
        want = jbert.param_logical_axes(keys, leaf)
        if keys[0] == "blocks":
            # The scanned axis: "layers" for a split leaf, None for a
            # replicated one (a bias, a LayerNorm parameter).
            assert want[0] in ("layers", None)
            want = want[1:]
            names = [f"layers.{i}." + ".".join(keys[1:])
                     for i in range(tmodel.cfg.n_layers)]
        else:
            names = [".".join(keys)]
        if keys[-1] == "kernel":
            want = want[::-1]
            names = [n[:-len("kernel")] + "weight" for n in names]
        elif keys[-1] == "embedding":
            names = [n[:-len("embedding")] + "weight" for n in names]
        for name in names:
            assert tbert.param_logical_axes(name, named[name]) == want, name
            seen.add(name)
    assert seen == set(named)


def test_three_trainer_steps_match_jax_trainer(f32):
    """adamw(1e-4) with mlm_loss, 3 steps on padded batches: losses and
    every parameter within 5e-4 of the JAX Trainer's."""
    jcfg, tcfg = configs()
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    jtrainer = jtr.Trainer(model=jbert.Bert(jcfg),
                           param_axes_fn=jbert.param_logical_axes,
                           rules=LLAMA_RULES, mesh=mesh,
                           optimizer=optax.adamw(LR),
                           loss_fn=jbert.mlm_loss)
    batches = [mlm_batch(10 + i, padded=True) for i in range(STEPS)]
    sample = jax.tree.map(jnp.asarray, batches[0])
    jstate, shardings = jtrainer.init(jax.random.PRNGKey(0), sample)
    start = randomized_norms_and_biases(jax.tree.map(np.asarray,
                                                     jstate.params))
    jstate = dataclasses.replace(jstate, params=jax.device_put(
        start, shardings.params))
    jstep = jtrainer.make_train_step(shardings, sample)
    model = tbert.Bert(tcfg, device="cpu")
    model.load_state_dict(bert_params_from_flax(start, tcfg))
    ttrainer = ttr.Trainer(model=model, optimizer=ttr.adamw(LR),
                           loss_fn=tbert.mlm_loss, device="cpu")
    tstate, tstep = ttrainer.init(), ttrainer.make_train_step()
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TRAIN_TOL,
                                   rtol=TRAIN_TOL)
    want = bert_params_from_flax(jax.tree.map(np.asarray, jstate.params),
                                 tcfg)
    first = bert_params_from_flax(start, tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=TRAIN_TOL, rtol=TRAIN_TOL,
                                   err_msg=name)
        assert not torch.equal(p.detach(), first[name]), name


def test_bert_mlm_learns():
    """The port of test_moe_bert_ckpt.py::test_bert_mlm_learns (adam(1e-2),
    10 steps on one masked batch; the JAX test's dp=2 x tp=4 mesh is held
    to JAX in tests/test_torch_distributed.py): the loss falls by 0.5."""
    cfg = dataclasses.replace(tbert.bert_tiny(), dtype=torch.float32)
    trainer = ttr.Trainer(model=tbert.Bert(cfg, device="cpu"),
                          optimizer=ttr.adam(1e-2), loss_fn=tbert.mlm_loss,
                          device="cpu")
    rnd = np.random.default_rng(0)
    b, s = 8, 32
    targets = rnd.integers(0, cfg.vocab_size, (b, s))
    mask = rnd.random((b, s)) < 0.15
    batch = {"inputs": np.where(mask, 0, targets), "targets": targets,
             "mask": mask}
    state, step = trainer.init(), trainer.make_train_step()
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_train_bert_payload_on_cpu(capsys):
    from tf_operator_tpu_torch.train import train_bert

    assert train_bert.main(["--size", "tiny", "--steps", "2",
                            "--batch-size", "2", "--seq-len", "32",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 1: loss=" in out and "bert training OK" in out
