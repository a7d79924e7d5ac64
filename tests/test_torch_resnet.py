"""Port parity: TPUBatchNorm, the ResNet (both stems, four norm schemes),
its weight bridge, the batch-stats and frozen-stats steps with SGD, and
the ResNet payload, against the JAX package on the CPU.

- ``TPUBatchNorm`` against the JAX ``tpu_batch_norm`` in every mode, at the
  tolerances of ``test_tpu_batch_norm_matches_flax``
  (tests/test_models_parallel.py): outputs 2e-5, means 1e-5, variances
  1e-4 + 1e-3 relative; ``torch.nn.BatchNorm2d`` fails them.
- The s2d stem against conv7 (1e-4, as the JAX test) and both layouts of
  its weight map exactly against the JAX one.
- ``resnet_tiny`` logits and updated statistics for every norm scheme and
  both stems, f32, within 1e-5, from the same randomised weights and
  statistics carried through the bridge; a symmetric 3x3/stride-2 padding
  fails that.
- One ``sgd(0.1, 0.9)`` step (two, so the momentum trace matters) and one
  frozen-statistics step against ``optax.sgd`` through the JAX ``Trainer``:
  parameters and statistics within 1e-5, frozen statistics bit-equal;
  ``steps_per_call`` as the JAX scan.
- bf16 logits against JAX judged against the logits' scale and the f32
  model (XLA's CPU bf16 is not correctly rounded).
- ResNet-50 at full width (53 convolutions) at 32x32, B=2, f32.
- A checkpoint after two steps restored into another seed's model: the
  third step bit-equal to the run that never stopped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import resnet as jrn
from tf_operator_tpu.ops.layers import tpu_batch_norm
from tf_operator_tpu.parallel.mesh import MeshConfig, make_mesh
from tf_operator_tpu.parallel.sharding import CNN_RULES
from tf_operator_tpu.train import trainer as jtr
from tf_operator_tpu_torch.models import resnet as trn
from tf_operator_tpu_torch.models.convert import (
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from tf_operator_tpu_torch.ops.layers import TPUBatchNorm
from tf_operator_tpu_torch.train import train_resnet
from tf_operator_tpu_torch.train import trainer as ttr
from tf_operator_tpu_torch.train.checkpoint import Checkpointer

pytestmark = pytest.mark.compute

NORMS = ("bn", "bn_bf16", "group", "affine")
STEMS = ("conv7", "s2d")
LOGITS_TOL = 1e-5


def randomize_norms(model, rng):
    """Norm scales, biases and statistics drawn away from their initial
    values (bn3's scale starts at zero, which would hide its branch)."""
    draws = {"scale": lambda n: 1 + 0.3 * rng.standard_normal(n),
             "bias": lambda n: 0.1 * rng.standard_normal(n),
             "mean": lambda n: 0.1 * rng.standard_normal(n),
             "var": lambda n: 1 + 0.5 * rng.random(n)}
    with torch.no_grad():
        for name, value in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if leaf in draws and value.ndim == 1 and "classifier" not in name:
                value.copy_(torch.tensor(draws[leaf](value.shape[0])))


def configs(dtype="float32", base="resnet_tiny", **fields):
    j = dataclasses.replace(getattr(jrn, base)(), dtype=getattr(jnp, dtype),
                            **fields)
    t = dataclasses.replace(getattr(trn, base)(),
                            dtype=getattr(torch, dtype), **fields)
    return j, t


def build(dtype="float32", seed=0, **fields):
    """The port's model from a seed (norm leaves randomised) and the same
    weights and statistics carried to flax: (flax model, params,
    batch_stats, port model)."""
    jcfg, tcfg = configs(dtype, **fields)
    tmodel = trn.ResNet(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    randomize_norms(tmodel, np.random.default_rng(seed + 100))
    params, stats = resnet_params_to_flax(tmodel.state_dict())
    return jrn.ResNet(jcfg), params, stats, tmodel


def images(batch=4, image=32, seed=2):
    return np.random.default_rng(seed).random((batch, image, image, 3),
                                              dtype=np.float32)


def jax_forward(jmodel, params, stats, x, **kwargs):
    """(logits, batch_stats after the call) of the flax model, jitted
    without XLA's excess precision: every bf16 op is rounded to bf16, as
    op by op and in the port (by default a CPU fusion keeps bf16
    intermediates in f32)."""
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats

    def run(variables, x):
        if stats:
            return jmodel.apply(variables, x, mutable=["batch_stats"],
                                **kwargs)
        return jmodel.apply(variables, x, **kwargs), {}

    x = jnp.asarray(x)
    compiled = jax.jit(run).lower(variables, x).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out, upd = compiled(variables, x)
    return (np.asarray(out, np.float32),
            jax.tree.map(np.asarray, dict(upd).get("batch_stats", {})))


def port_stats(tmodel):
    return resnet_params_to_flax(tmodel.state_dict())[1]


def assert_trees_close(got, want, atol, rtol=0.0):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_allclose(flat_got[path], leaf, atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# TPUBatchNorm
# ---------------------------------------------------------------------------

BN_MODES = {
    # name: (JAX/port module kwargs, use_running_average, input dtype)
    "bn": (dict(), False, "float32"),
    "bn_bf16": (dict(stats_dtype="bfloat16"), False, "float32"),
    "frozen": (dict(), True, "float32"),
    "untracked": (dict(track_stats=False), False, "float32"),
    "unit": (dict(track_stats=False), True, "float32"),
    "bf16_out": (dict(dtype="bfloat16"), False, "bfloat16"),
}
BN_SHAPES = [(8, 14, 14, 32), (2, 3, 3, 16)]


def bn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    leaves = {"scale": (1 + 0.3 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
              "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
              "var": (1 + 0.5 * rng.random(c)).astype(np.float32)}
    return x, leaves


def jax_bn(x, leaves, mode):
    kwargs, running, dtype = BN_MODES[mode]
    kwargs = {k: getattr(jnp, v) if "dtype" in k else v
              for k, v in kwargs.items()}
    m = tpu_batch_norm(use_running_average=running, **kwargs)
    variables = {"params": {"scale": leaves["scale"],
                            "bias": leaves["bias"]}}
    if kwargs.get("track_stats", True):
        variables["batch_stats"] = {"mean": leaves["mean"],
                                    "var": leaves["var"]}
    y, upd = m.apply(variables, jnp.asarray(x).astype(getattr(jnp, dtype)),
                     mutable=["batch_stats"])
    return (np.asarray(y, np.float32),
            jax.tree.map(np.asarray, dict(upd).get("batch_stats", {})))


def port_bn(x, leaves, mode):
    kwargs, running, dtype = BN_MODES[mode]
    kwargs = {k: getattr(torch, v) if "dtype" in k else v
              for k, v in kwargs.items()}
    m = TPUBatchNorm(x.shape[-1], device="cpu", **kwargs)
    m.load_state_dict({k: torch.tensor(v) for k, v in leaves.items()
                       if k in m.state_dict()})
    xt = torch.tensor(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    y = m(xt, use_running_average=running).permute(0, 2, 3, 1)
    stats = {k: v.numpy() for k, v in m.named_buffers()}
    return y.detach().float().numpy(), stats


def assert_bn_close(got, want):
    (y, stats), (y_want, stats_want) = got, want
    np.testing.assert_allclose(y, y_want, atol=2e-5, rtol=2e-5)
    assert set(stats) == set(stats_want)
    if stats_want:
        np.testing.assert_allclose(stats["mean"], stats_want["mean"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(stats["var"], stats_want["var"],
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", BN_SHAPES, ids=str)
@pytest.mark.parametrize("mode", sorted(set(BN_MODES) - {"bf16_out"}))
def test_batch_norm_matches_jax(mode, shape):
    x, leaves = bn_inputs(shape)
    got, want = port_bn(x, leaves, mode), jax_bn(x, leaves, mode)
    assert_bn_close(got, want)
    if mode in ("frozen", "unit", "untracked"):
        # Nothing updated: the statistics are the ones loaded, or none.
        assert all(np.array_equal(v, leaves[k]) for k, v in got[1].items())
    else:
        assert not np.array_equal(got[1]["var"], leaves["var"])


@pytest.mark.parametrize("shape", BN_SHAPES, ids=str)
def test_batch_norm_bf16_output(shape):
    """dtype=bf16: statistics in f32 as in f32 mode; the output x·a + b in
    bf16, within one bf16 rounding (2**-8 relative) of the outputs'
    scale."""
    x, leaves = bn_inputs(shape)
    (y, stats), (y_want, stats_want) = (port_bn(x, leaves, "bf16_out"),
                                        jax_bn(x, leaves, "bf16_out"))
    assert np.abs(y - y_want).max() <= 2 ** -8 * np.abs(y_want).max()
    np.testing.assert_allclose(stats["mean"], stats_want["mean"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(stats["var"], stats_want["var"], atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("momentum", [0.1, 0.9])
def test_torch_batch_norm2d_fails_the_tolerance(momentum):
    """torch.nn.BatchNorm2d with the same scale, bias, statistics and eps:
    at its momentum 0.1 (flax's 0.9 read as 1 − momentum) its unbiased
    running variance fails; at 0.9 its running mean fails too."""
    x, leaves = bn_inputs((2, 3, 3, 16))
    bn = torch.nn.BatchNorm2d(16, eps=1e-5, momentum=momentum)
    bn.load_state_dict({"weight": torch.tensor(leaves["scale"]),
                        "bias": torch.tensor(leaves["bias"]),
                        "running_mean": torch.tensor(leaves["mean"]),
                        "running_var": torch.tensor(leaves["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    y = bn(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = (y.detach().numpy(), {"mean": bn.running_mean.numpy(),
                                "var": bn.running_var.numpy()})
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        assert_bn_close(got, jax_bn(x, leaves, "bn"))
    # The port's layer passes the same comparison.
    assert_bn_close(port_bn(x, leaves, "bn"), jax_bn(x, leaves, "bn"))


# ---------------------------------------------------------------------------
# Stems
# ---------------------------------------------------------------------------

def test_space_to_depth_and_s2d_kernels_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trn.space_to_depth(torch.tensor(x)).numpy(),
        np.asarray(jrn.space_to_depth(jnp.asarray(x))))
    w7 = rng.standard_normal((7, 7, 3, 5)).astype(np.float32)
    want = np.asarray(jrn.s2d_stem_kernel(jnp.asarray(w7)))
    np.testing.assert_array_equal(
        trn.s2d_stem_kernel(torch.tensor(w7)).numpy(), want)
    oihw = trn.s2d_stem_kernel_oihw(torch.tensor(w7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(oihw.numpy(), want.transpose(3, 2, 0, 1))


def test_s2d_stem_exact_vs_conv7():
    """The port's two stems compute the same function on the same 7x7
    weights (f32, 1e-4 as the JAX test)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 224, 224, 3, generator=gen)
    w7 = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
    convs = {}
    for stem in STEMS:
        cfg = dataclasses.replace(trn.resnet_tiny(), stem=stem, width=64,
                                  dtype=torch.float32)
        model = trn.ResNet(cfg, device="cpu")
        conv = model.stem_conv_s2d if stem == "s2d" else model.stem_conv
        with torch.no_grad():
            conv.weight.copy_(w7 if stem == "conv7"
                              else trn.s2d_stem_kernel_oihw(w7))
        convs[stem] = conv
    with torch.no_grad():
        ref = convs["conv7"](x.permute(0, 3, 1, 2))
        got = convs["s2d"](trn.space_to_depth(x).permute(0, 3, 1, 2))
    assert ref.shape == got.shape == (2, 64, 112, 112)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size, kernel, stride, want", [
    (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (112, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (1, 3, 2, (1, 1))])
def test_same_padding_is_xla_same(size, kernel, stride, want):
    assert trn.same_padding(size, kernel, stride) == want
    pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tuple(pads[0]) == want


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("norm", NORMS)
def test_resnet_tiny_matches_jax(norm, stem):
    """Training-mode logits and updated statistics, f32, within 1e-5.

    Under ``bn_bf16`` the statistics are bf16: an f32 activation that
    differs in its last bit between the packages can move a batch
    statistic to the neighbouring bf16 value (2**-8 relative; measured: one
    channel's mean, 1.2e-5 in its running mean), so there the limit is
    one such rounding: 0.1 · 2**-8 · |batch statistic| on a running
    statistic, 2**-8 of the logits' scale on the logits."""
    jmodel, params, stats, tmodel = build(norm=norm, stem=stem)
    x = images()
    want, want_stats = jax_forward(jmodel, params, stats, x)
    got = tmodel(torch.tensor(x)).detach().numpy()
    got_stats = port_stats(tmodel)
    assert got.shape == want.shape == (4, 10)
    assert bool(want_stats) == (norm in ("bn", "bn_bf16"))
    if norm != "bn_bf16":
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        assert_trees_close(got_stats, want_stats, atol=LOGITS_TOL,
                           rtol=LOGITS_TOL)
        return
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    old = dict(jax.tree_util.tree_leaves_with_path(stats))
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got_stats))
    for path, new in jax.tree_util.tree_leaves_with_path(want_stats):
        batch = np.abs(new - 0.9 * old[path]) / 0.1
        limit = LOGITS_TOL + 0.1 * 2 ** -8 * batch
        assert (np.abs(got_flat[path] - new) <= limit).all(), path


@pytest.mark.parametrize("mode", ["eval", "update_stats_false"])
@pytest.mark.parametrize("norm", ["bn", "bn_bf16"])
def test_running_statistics_modes_match_jax(norm, mode):
    """Eval mode (flax train=False) and update_stats=False normalise with
    the running statistics and leave them as they are."""
    jmodel, params, stats, tmodel = build(norm=norm)
    x = images()
    kwargs = {"train": False} if mode == "eval" else {"update_stats": False}
    want, want_stats = jax_forward(jmodel, params, stats, x, **kwargs)
    if mode == "eval":
        tmodel.eval()
        got = tmodel(torch.tensor(x))
    else:
        got = tmodel(torch.tensor(x), update_stats=False)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    assert_trees_close(port_stats(tmodel), stats, atol=0)
    assert_trees_close(want_stats, stats, atol=0)


def test_symmetric_padding_fails(monkeypatch):
    """Padding a 3x3/stride-2 conv and the max pool (1, 1), as
    F.conv2d(padding=1) would, moves the logits far past 1e-5."""
    jmodel, params, stats, tmodel = build()
    x = images()
    want, _ = jax_forward(jmodel, params, stats, x)
    monkeypatch.setattr(trn, "same_padding",
                        lambda size, kernel, stride: ((kernel - 1) // 2,) * 2)
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    assert np.abs(got - want).max() > 1e3 * LOGITS_TOL


def test_bf16_logits_match_jax():
    """bf16 logits (bn, s2d) within 2e-2 of JAX's, measured against the
    logits' scale, and no further from the f32 model than JAX's own bf16
    run is (x1.25)."""
    fields = dict(norm="bn", stem="s2d")
    jmodel, params, stats, tmodel = build(dtype="bfloat16", **fields)
    jf32, _, _, _ = build(**fields)
    x = images()
    want, _ = jax_forward(jmodel, params, stats, x)
    truth, _ = jax_forward(jf32, params, stats, x)
    with torch.no_grad():
        got = tmodel(torch.tensor(x))
    assert got.dtype == torch.float32      # the f32 classifier
    got = got.numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= 2e-2
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert rel(got, truth) <= 1.25 * rel(want, truth)


def test_resnet50_full_width_matches_jax():
    """ResNet-50 (stages 3, 4, 6, 3, width 64, 1000 classes) at 32x32, B=2,
    f32: random port weights carried to flax over all 53 convolutions and
    back exactly; eval-mode logits within 1e-5. In training mode the last
    stage's BatchNorm sees 2 values a channel (1x1 spatial, B=2), where
    E[x²] − E[x]² cancels most of its digits, so rounding differences grow
    (measured 1e-4 of the logits' scale): logits and statistics within
    1e-3 there."""
    _, tcfg = configs(base="resnet50")
    tmodel = trn.ResNet(tcfg, device="cpu")
    state = tmodel.state_dict()
    params, stats = resnet_params_to_flax(state)
    convs = [k for k, v in state.items() if v.ndim == 4]
    assert len(convs) == 53
    back = resnet_params_from_flax(params, stats)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)

    jcfg, _ = configs(base="resnet50")
    jmodel = jrn.ResNet(jcfg)
    x = images(batch=2)
    want, _ = jax_forward(jmodel, params, stats, x, train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 1000)
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=LOGITS_TOL)

    want, want_stats = jax_forward(jmodel, params, stats, x)
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.tensor(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    assert_trees_close(port_stats(tmodel), want_stats, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# Bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("norm", NORMS)
def test_bridge_matches_the_flax_tree_and_round_trips(norm, stem):
    """The port's state carried to flax has the flax model's own tree
    (paths and shapes, from ``init``'s shapes) and comes back exactly."""
    jmodel, params, stats, tmodel = build(norm=norm, stem=stem, seed=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    for got, want in ((params, shapes["params"]),
                      (stats, shapes.get("batch_stats", {}))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [
            a.shape for a in jax.tree.leaves(want)]
    back = resnet_params_from_flax(params, stats)
    state = tmodel.state_dict()
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    if norm == "group":
        assert "GroupNorm_0" in params["stem_bn"]
        assert "stem_bn.GroupNorm_0.scale" in tmodel.state_dict()
    assert ("stem_conv_s2d" in params) == (stem == "s2d")


def test_bridge_raises_on_leaves_left_over_or_missing():
    _, params, stats, tmodel = build()
    extra = dict(params, stem_bn=dict(params["stem_bn"], offset=np.zeros(8)))
    with pytest.raises(KeyError, match="expected"):
        resnet_params_from_flax(extra, stats)
    missing = dict(stats)
    del missing["stem_bn"]
    with pytest.raises(KeyError, match="lack stem_bn"):
        resnet_params_from_flax(params, missing)
    stray = dict(stats, classifier={"mean": np.zeros(10),
                                    "var": np.ones(10)})
    with pytest.raises(KeyError, match="left over"):
        resnet_params_from_flax(params, stray)
    with pytest.raises(KeyError, match="no weight"):
        resnet_params_to_flax(dict(tmodel.state_dict(),
                                   **{"stem_bn.count": torch.zeros(1)}))


def test_unknown_norm_or_stem_raises():
    for fields in (dict(norm="layer"), dict(stem="conv3")):
        cfg = dataclasses.replace(trn.resnet_tiny(), **fields)
        with pytest.raises(ValueError, match="unknown"):
            trn.ResNet(cfg, device="cpu")


def test_synthetic_batch_from_an_explicit_generator():
    a = trn.synthetic_batch(torch.Generator().manual_seed(3), 4, 16, 7)
    b = trn.synthetic_batch(torch.Generator().manual_seed(3), 4, 16, 7)
    assert a["inputs"].shape == (4, 16, 16, 3)
    assert a["labels"].shape == (4,) and int(a["labels"].max()) < 7
    assert 0 <= float(a["inputs"].min()) and float(a["inputs"].max()) < 1
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_resnet50_configs_match_jax():
    for stem in STEMS:
        want, got = jrn.resnet50(stem=stem), trn.resnet50(stem=stem)
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.bfloat16
    assert trn.resnet_tiny().stage_sizes == jrn.resnet_tiny().stage_sizes


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_optax(momentum):
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in [(8, 4), (4,), (3, 5)]]
    grads_seq = [[rng.standard_normal(p.shape).astype(np.float32)
                  for p in params] for _ in range(3)]
    tx = optax.sgd(0.1, momentum=momentum)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for grads in grads_seq:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
    opt = ttr.sgd(0.1, momentum=momentum)
    tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    torch_opt = opt.make(tparams)
    for count, grads in enumerate(grads_seq):
        for p, g in zip(tparams, grads):
            p.grad = torch.tensor(g)
        opt.apply(torch_opt, count)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def jax_trainer(jmodel, loss_fn):
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices()[:1])
    return jtr.Trainer(model=jmodel, param_axes_fn=jrn.param_logical_axes,
                       rules=CNN_RULES, mesh=mesh,
                       optimizer=optax.sgd(0.1, momentum=0.9),
                       loss_fn=loss_fn)


def train_batches(n, batch=8, image=32, seed=0):
    data = np.random.default_rng(seed)
    return [{"inputs": data.random((batch, image, image, 3),
                                   dtype=np.float32),
             "labels": data.integers(0, 10, (batch,)).astype(np.int32)}
            for _ in range(n)]


def jax_state(trainer, params, stats, sample):
    """The JAX TrainState of these weights and statistics with a fresh
    optimizer state, and its shardings (traced, not run)."""
    shardings = trainer.state_shardings(jax.random.PRNGKey(0), sample)
    params = jax.tree.map(jnp.asarray, params)
    state = jtr.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=trainer.optimizer.init(params),
        extra_vars={"batch_stats": jax.tree.map(jnp.asarray, stats)})
    return jax.device_put(state, shardings), shardings


def assert_state_matches(tmodel, jstate, atol=1e-5):
    params, stats = resnet_params_to_flax(tmodel.state_dict())
    assert_trees_close(params, jax.tree.map(np.asarray, jstate.params),
                       atol=atol, rtol=atol)
    assert_trees_close(stats, jax.tree.map(
        np.asarray, jstate.extra_vars["batch_stats"]), atol=atol, rtol=atol)


STEP_LOSSES = {
    "classification": (jtr.classification_loss, ttr.classification_loss, 2),
    "frozen_stats": (jtr.classification_loss_frozen_stats,
                     ttr.classification_loss_frozen_stats, 1),
}


@pytest.mark.parametrize("loss", sorted(STEP_LOSSES))
def test_sgd_steps_match_the_jax_trainer(loss):
    """sgd(0.1, 0.9) through both trainers from the same weights: two
    classification_loss steps (the second reads the momentum trace) or one
    frozen-statistics step. Losses, parameters and statistics within 1e-5;
    the frozen step leaves the statistics bit-equal and moves the
    parameters. (After a frozen step the stem's ReLU sees pre-activations
    within 5e-7 of zero, where the two packages' 1e-7 rounding can flip a
    ReLU gradient: each loss starts from the same weights.)"""
    jloss, tloss, steps = STEP_LOSSES[loss]
    jmodel, params, stats, tmodel = build()
    batches = train_batches(steps)
    sample = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jtrainer = jax_trainer(jmodel, jloss)
    jstate, shardings = jax_state(jtrainer, params, stats, sample)
    jstep = jtrainer.make_train_step(shardings, sample)
    ttrainer = ttr.Trainer(model=tmodel, optimizer=ttr.sgd(0.1, 0.9),
                           loss_fn=tloss, device="cpu")
    tstate, tstep = ttrainer.init(), ttrainer.make_train_step()
    kept = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-5)
        assert tm["step"] == int(jm["step"]) == i
        assert_state_matches(tmodel, jstate)
    assert tstate.step == steps
    now = tmodel.state_dict()
    buffers = [k for k, _ in tmodel.named_buffers()]
    assert buffers and not torch.equal(now["stem_conv.weight"],
                                       kept["stem_conv.weight"])
    same = [torch.equal(now[k], kept[k]) for k in buffers]
    assert all(same) if loss == "frozen_stats" else not any(same)


def test_steps_per_call_matches_the_jax_scan():
    """steps_per_call=3 on one batch: 3 updates a call, the metrics of the
    last, step 2 then 5 (as test_multi_step_dispatch_same_batch_mode), and
    the JAX scan's parameters and statistics within 1e-5."""
    jmodel, params, stats, tmodel = build()
    batch = train_batches(1)[0]
    sample = {k: jnp.asarray(v) for k, v in batch.items()}
    jtrainer = jax_trainer(jmodel, jtr.classification_loss)
    jstate, shardings = jax_state(jtrainer, params, stats, sample)
    jstep = jtrainer.make_train_step(shardings, sample, steps_per_call=3)
    ttrainer = ttr.Trainer(model=tmodel, optimizer=ttr.sgd(0.1, 0.9),
                           loss_fn=ttr.classification_loss, device="cpu")
    tstate, tstep = ttrainer.init(), ttrainer.make_train_step(
        steps_per_call=3)
    for want_step in (2, 5):
        jstate, jm = jstep(jstate, sample)
        tstate, tm = tstep(tstate, batch)
        assert tm["step"] == int(jm["step"]) == want_step
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-5)
    assert tstate.step == 6
    assert_state_matches(tmodel, jstate)


def test_stacked_batches_take_one_slice_an_update():
    """stacked_batches: a [K, ...] batch is K updates on its slices, the
    same numbers as K single steps."""
    batches = train_batches(3, batch=4)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    results = []
    for k, feed in ((3, [stacked]), (1, batches)):
        _, _, _, tmodel = build()
        trainer = ttr.Trainer(model=tmodel, optimizer=ttr.sgd(0.1, 0.9),
                              loss_fn=ttr.classification_loss, device="cpu")
        state = trainer.init()
        step = trainer.make_train_step(steps_per_call=k,
                                       stacked_batches=True)
        for batch in feed:
            state, metrics = step(state, batch)
        results.append((metrics, tmodel.state_dict()))
    (m_a, sd_a), (m_b, sd_b) = results
    assert m_a["step"] == m_b["step"] == 2
    assert torch.equal(m_a["loss"], m_b["loss"])
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def test_state_dict_carries_the_batch_norm_statistics():
    _, _, _, tmodel = build()
    state = ttr.Trainer(model=tmodel, optimizer=ttr.sgd(0.1, 0.9),
                        device="cpu").init().state_dict()
    buffers = dict(tmodel.named_buffers())
    assert buffers and set(buffers) <= set(state["model"])
    # The live tensors: a restore into this dict is a restore in place.
    assert all(state["model"][k].data_ptr() == v.data_ptr()
               for k, v in buffers.items())


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Save after two steps, restore into a model from another seed, take
    a third step: parameters, statistics and loss equal the run that never
    stopped bit for bit (the JAX TrainState.extra_vars round trip)."""
    batches = train_batches(3, batch=4)

    def trainer(seed):
        cfg = dataclasses.replace(trn.resnet_tiny(), dtype=torch.float32)
        model = trn.ResNet(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
        tr = ttr.Trainer(model=model, optimizer=ttr.sgd(0.1, 0.9),
                         loss_fn=ttr.classification_loss, device="cpu")
        return model, tr.init(), tr.make_train_step()

    model, state, step = trainer(0)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, state)
    ckpt.wait()
    state, want = step(state, batches[2])
    want_state = {k: v.clone() for k, v in model.state_dict().items()}

    other, restored, other_step = trainer(1)
    assert not torch.equal(other.stem_conv.weight, want_state[
        "stem_conv.weight"])
    ckpt.restore(restored)
    ckpt.close()
    assert restored.step == 2
    restored, got = other_step(restored, batches[2])
    assert torch.equal(got["loss"], want["loss"])
    for name, value in other.state_dict().items():
        assert torch.equal(value, want_state[name]), name
    assert any(name.endswith(".var") for name in want_state)


def test_payload_runs_on_the_cpu(capsys):
    assert train_resnet.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 3: loss=" in out and out.rstrip().endswith(
        "resnet training OK")
