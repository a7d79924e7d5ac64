"""Port parity: the port's Llama against the flax Llama on converted weights.

A 2-layer model at head_dim 128 (hidden 256, 2 heads, 1 KV head, mlp 512,
vocab 512) in f32, B=2, S=128: the JAX side runs ``attention_impl="flash"``
(its Pallas kernels in interpret mode), the port its flash path (the plain
versions on the CPU). Logits agree within 1e-4, the loss and every
parameter's gradient within 5e-4, bf16 logits within 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.train.trainer import cross_entropy_loss as j_ce
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.convert import (
    llama_params_from_flax,
    llama_params_to_flax,
)
from tf_operator_tpu_torch.train.trainer import lm_loss

pytestmark = pytest.mark.compute

FLASH = dict(vocab_size=512, hidden=256, n_layers=2, n_heads=2, n_kv_heads=1,
             head_dim=128, mlp_dim=512, max_seq_len=256, rope_theta=10000.0,
             remat=False, attention_impl="flash")
B, S = 2, 128


def configs(dtype="float32", **fields):
    """The same config for both packages (JAX dtype, torch dtype)."""
    j = jllama.LlamaConfig(dtype=getattr(jnp, dtype), **fields)
    t = tllama.LlamaConfig(dtype=getattr(torch, dtype), **fields)
    return j, t


def tiny_fields():
    cfg = jllama.llama_tiny(vocab_size=512, max_seq_len=256)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "sp_axis", "decode")}


def tokens(seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1))


def build(fields, dtype="float32", seed=0):
    """flax params from a seed, and the port's model loaded with them."""
    jcfg, tcfg = configs(dtype, **fields)
    jmodel = jllama.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(llama_params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def flash_f32():
    return build(FLASH)


def test_bridge_round_trips(flash_f32):
    _, params, tmodel = flash_f32
    back = llama_params_to_flax(tmodel.state_dict(), tmodel.cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_bridge_raises_on_leftover_and_missing(flash_f32):
    _, params, tmodel = flash_f32
    extra = dict(params, stray={"kernel": np.zeros(3)})
    with pytest.raises(KeyError, match="left over"):
        llama_params_from_flax(extra, tmodel.cfg)
    missing = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        llama_params_from_flax(missing, tmodel.cfg)
    state = dict(tmodel.state_dict(), stray=torch.zeros(1))
    with pytest.raises(KeyError, match="left over"):
        llama_params_to_flax(state, tmodel.cfg)


@pytest.mark.parametrize("which", ["flash", "tiny_xla"])
def test_logits_match_jax(which, flash_f32):
    jmodel, params, tmodel = (flash_f32 if which == "flash"
                              else build(tiny_fields()))
    toks = tokens()[:, :-1]
    want = jmodel.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel(torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _torch_grads(tmodel, toks):
    tmodel.zero_grad(set_to_none=True)
    loss = lm_loss(tmodel, {"inputs": torch.tensor(toks)})
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tmodel.named_parameters()}


def test_loss_and_every_grad_match_jax(flash_f32):
    jmodel, params, tmodel = flash_f32
    toks = tokens(1)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(toks[:, :-1]))
        return j_ce(logits, jnp.asarray(toks[:, 1:]))

    j_loss, j_grads = jax.value_and_grad(loss_of)(params)
    want = llama_params_from_flax(jax.tree.map(np.asarray, j_grads),
                                  tmodel.cfg)
    t_loss, got = _torch_grads(tmodel, toks)
    np.testing.assert_allclose(t_loss, float(j_loss), atol=5e-4, rtol=5e-4)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


def test_remat_full_matches_no_remat(flash_f32):
    _, params, tmodel = flash_f32
    remat = tllama.Llama(dataclasses.replace(tmodel.cfg, remat=True),
                         device="cpu")
    remat.load_state_dict(tmodel.state_dict())
    toks = tokens(2)
    loss_a, grads_a = _torch_grads(tmodel, toks)
    loss_b, grads_b = _torch_grads(remat, toks)
    assert loss_a == pytest.approx(loss_b, abs=1e-6)
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], atol=1e-6,
                                   rtol=1e-6, msg=name)


def test_bf16_logits_match_jax(flash_f32):
    """bf16 logits within 2e-2 of JAX's, measured against the logits'
    scale: XLA's CPU bf16 ``logistic`` (in silu) is not correctly rounded
    (up to one bf16 ulp off), while torch's is, so near-zero logits differ
    by a few ulps of the scale. The port must also be no further from
    the f32 model than JAX's own bf16 run is."""
    jmodel, params, tmodel = build(FLASH, dtype="bfloat16")
    jf32, params_f32, _ = flash_f32
    toks = tokens(3)[:, :-1]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks)),
                      np.float32)
    truth = np.asarray(jf32.apply({"params": params_f32},
                                  jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.tensor(toks))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= 2e-2
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert rel(got, truth) <= 1.25 * rel(want, truth)


@pytest.mark.parametrize("fields, error", [
    (dict(attention_impl="ring"), ValueError),
    (dict(attention_impl="ring_flash"), ValueError),
    (dict(remat=True, remat_policy="bogus"), ValueError),
    (dict(attention_impl="bogus"), ValueError),
])
def test_unported_options_raise(fields, error):
    """Unknown options raise when the model is built; the ring modes
    (ported since) raise at the forward without an active mesh, as the
    JAX model's do."""
    cfg = dataclasses.replace(tllama.llama_tiny(), **fields)
    with pytest.raises(error, match="active mesh|unknown"):
        tllama.Llama(cfg, device="cpu")(torch.zeros((1, 8),
                                                    dtype=torch.long))


@pytest.mark.parametrize("policy", ["save_qkv", "save_attn", "mlp_only"])
def test_remat_policies_accepted_and_match_full(policy, flash_f32):
    """The policies that raised before they were ported: accepted, with
    the same parameters, loss and grads as remat "full" (f32, 1e-6).
    tests/test_torch_remat.py holds them against JAX and counts kernels."""
    _, _, tmodel = flash_f32
    models = {}
    for name in ("full", policy):
        models[name] = tllama.Llama(dataclasses.replace(
            tmodel.cfg, remat=True, remat_policy=name), device="cpu")
        models[name].load_state_dict(tmodel.state_dict())
    toks = tokens(4)
    loss_a, grads_a = _torch_grads(models["full"], toks)
    loss_b, grads_b = _torch_grads(models[policy], toks)
    assert set(grads_b) == set(grads_a)
    assert loss_b == pytest.approx(loss_a, abs=1e-6)
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], atol=1e-6,
                                   rtol=1e-6, msg=name)


def test_llama_3_8b_widths():
    want = jllama.llama_3_8b()
    got = tllama.llama_3_8b()
    for f in dataclasses.fields(got):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("n_heads, n_kv_heads, tp", [
    (4, 2, 4),      # llama_tiny at tp=4: one query head a rank
    (32, 8, 16),    # llama_3_8b at tp=16: two query heads on one KV head
    (12, 6, 4),     # three query heads a rank, straddling two KV heads
])
def test_own_kv_matches_jax_repeated_slice(n_heads, n_kv_heads, tp):
    """Where tp divides the query heads but not the KV heads, each rank's
    query heads read the same K/V through ``_own_kv`` as through JAX's
    layout: K/V repeated to full heads, sliced to the rank's heads."""
    from tf_operator_tpu.ops.layers import repeat_kv as jrepeat_kv
    from tf_operator_tpu_torch.ops.layers import repeat_kv

    rng = np.random.default_rng(n_heads)
    k, v = (rng.standard_normal((2, 8, n_kv_heads, 4)).astype(np.float32)
            for _ in range(2))
    group, local = n_heads // n_kv_heads, n_heads // tp
    for rank in range(tp):
        first = rank * local
        kk, vv = tllama._own_kv(torch.tensor(k), torch.tensor(v), first,
                                local, group)
        assert local % kk.shape[2] == 0
        for got, x in ((kk, k), (vv, v)):
            want = np.asarray(jrepeat_kv(jnp.asarray(x), group))
            np.testing.assert_array_equal(
                repeat_kv(got, local // got.shape[2]).numpy(),
                want[:, :, first:first + local])
