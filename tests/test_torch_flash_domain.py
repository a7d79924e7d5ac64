"""Port parity over the TPU kernels' whole domain: ragged sequences, fp16,
f32 and head_dim 256-512, against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain versions and the JAX side
runs its kernels in interpret mode (as tests/test_flash_attention.py
does), on the same numpy inputs cast to the case's dtype. Limits follow
the reference's own tests: f32 forward and lse 2e-5, gradients 5e-4; bf16
2e-2 of each output's largest value (chip_smoke.py's scaled check at
rel 2e-2, so a zero output cannot pass); fp16, whose rounding is finer
than bf16's, is held to the same 2e-2. The gate is compared with JAX's
over a grid of shapes, and chip_smoke.py's kernel check must reject every
perturbation of the domain's edges.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import flash_attention as jfa
from tf_operator_tpu_torch.ops import flash_attention as tfa
from tf_operator_tpu_torch.ops import ring_attention as tra

pytestmark = pytest.mark.compute

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SEQS = (4, 8, 16, 56, 64, 100, 200, 1000, 2000, 2048)
HEAD_DIMS = (64, 128, 256, 384, 512, 640)
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}

# (batch, q_seq, k_seq, heads, kv_heads, causal, q_offset, dtype, head_dim)
CASES = {
    "ragged_200": (1, 200, 200, 2, 1, True, 0, torch.float32, 128),
    "ragged_q_offset": (1, 72, 200, 2, 1, True, 128, torch.float32, 128),
    "s8": (2, 8, 8, 2, 1, True, 0, torch.float32, 128),
    "fp16_128": (1, 136, 136, 2, 1, True, 0, torch.float16, 128),
    "f32_256": (1, 72, 136, 2, 2, False, 0, torch.float32, 256),
    "bf16_384": (1, 136, 136, 2, 1, True, 0, torch.bfloat16, 384),
    "f32_512_gqa_4_1": (1, 72, 72, 4, 1, True, 0, torch.float32, 512),
}


def _inputs(case, seed=0):
    """numpy f32 q, k, v, do (do in the case's dtype's grid too)."""
    b, sq, sk, h, hkv, *_, d = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, sk, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, sk, hkv, d)) * 0.5).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _assert_close(name, got, want, dtype, tol):
    """f32: within ``tol``; bf16/fp16: chip_smoke's check scaled to the
    output at 2e-2 (rel L2 and per element)."""
    got = torch.tensor(np.asarray(got, np.float32))
    want = torch.tensor(np.asarray(want, np.float32))
    assert got.shape == want.shape, name
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                   rtol=tol, err_msg=name)
        return
    result = smoke.check(name, got, want, rel=2e-2, tol=2e-2,
                         lse_atol=2e-2)
    assert result["ok"], (name, result)


def test_flash_supported_matches_jax_over_the_grid():
    """The port's gate is JAX's at its default blocks on every (sq, sk,
    D), and takes exactly bf16, fp16 and f32."""
    for sq in SEQS:
        for sk in SEQS:
            for d in HEAD_DIMS:
                want = jfa.flash_supported(sq, sk, d)
                assert tfa.flash_supported(sq, sk, d) == want, (sq, sk, d)
                for dtype in (torch.bfloat16, torch.float16, torch.float32):
                    assert tfa.flash_supported(sq, sk, d, dtype) == want
                for dtype in (torch.float64, torch.int32, torch.int8,
                              torch.bool):
                    assert not tfa.flash_supported(sq, sk, d, dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case):
    *_, causal, q_offset, dtype, _ = CASES[case]
    q, k, v, _ = _inputs(case)
    jx = [jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v)]
    want = jfa.flash_attention(*jx, causal=causal, q_offset=q_offset,
                               interpret=True)
    tq, tk, tv = (torch.tensor(x).to(dtype) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype
    _assert_close("out", got.float(), want, dtype, 2e-5)
    qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in jx)
    _, want_lse = jfa._fwd(qt, kt, vt, causal, q_offset,
                           jfa._fit_block(q.shape[1], jfa.DEFAULT_BLOCK_Q),
                           jfa._fit_block(k.shape[1], jfa.DEFAULT_BLOCK_K),
                           True)
    _, got_lse = tfa._fwd(tq, tk, tv, causal, q_offset)
    _assert_close("lse", got_lse, np.asarray(want_lse)[..., 0], dtype,
                  2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    *_, causal, q_offset, dtype, _ = CASES[case]
    q, k, v, do = _inputs(case, seed=1)
    jdo = jnp.asarray(do, JAX_DTYPE[dtype])

    def loss(a, b_, c):
        out = jfa.flash_attention(a, b_, c, causal=causal,
                                  q_offset=q_offset, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v)))
    leaves = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    out.backward(torch.tensor(do).to(dtype))
    for name, g, w in zip("qkv", leaves, want):
        assert g.grad.dtype == dtype
        _assert_close(f"d{name}", g.grad.float(), np.asarray(w, np.float32),
                      dtype, 5e-4)


@pytest.mark.parametrize("case", ["ragged_q_offset", "bf16_384"])
def test_best_attention_forced_matches_jax(case):
    """best_attention(force_flash=True) takes the new domain on the CPU
    (the plain versions) and agrees with JAX's forced Pallas path."""
    *_, causal, q_offset, dtype, _ = CASES[case]
    q, k, v, _ = _inputs(case, seed=2)
    want = jfa.best_attention(
        *(jnp.asarray(x, JAX_DTYPE[dtype]) for x in (q, k, v)),
        causal=causal, q_offset=q_offset, force_flash=True)
    got = tfa.best_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)),
                             causal=causal, q_offset=q_offset,
                             force_flash=True)
    _assert_close("out", got.float(), want, dtype, 2e-5)


def test_ring_auto_rule_matches_jax():
    """resolve_impl("auto") picks the flash ring exactly where JAX's
    ring_attention_sharded(impl="auto") does: f32 and ragged blocks
    included (its rule: flash_supported at the fitted blocks, GQA heads
    dividing)."""
    for s_blk in SEQS:
        for d in (64, 128, 256, 512, 640):
            for heads in ((4, 2), (4, 3)):
                jax_flash = (jfa.flash_supported(
                    s_blk, s_blk, d, jfa._fit_block(s_blk, 512),
                    jfa._fit_block(s_blk, 1024))
                    and heads[0] % heads[1] == 0)
                for dtype in (torch.float32, torch.bfloat16, torch.float16):
                    got = tra.resolve_impl("auto", s_blk, d, *heads, dtype)
                    assert got == ("flash" if jax_flash else "einsum"), (
                        s_blk, d, heads, dtype)


# (q_seq, k_seq, causal, q_offset, dtype, head_dim): the kernels phase's
# ragged and wide cases, cut to 2 query heads over 1 KV head.
PERTURBED_CASES = {
    "ragged_2000": (2000, 2000, True, 0, torch.bfloat16, 128),
    "ragged_q_offset": (72, 200, True, 128, torch.bfloat16, 128),
    "s8": (8, 8, True, 0, torch.bfloat16, 128),
    "f32_ragged_noncausal": (200, 200, False, 0, torch.float32, 128),
    "f32_512": (200, 200, False, 0, torch.float32, 512),
    "bf16_256": (136, 136, True, 0, torch.bfloat16, 256),
    "bf16_384_q_offset": (72, 200, True, 128, torch.bfloat16, 384),
    "fp16_512": (136, 136, True, 0, torch.float16, 512),
}


@pytest.mark.parametrize("case", sorted(PERTURBED_CASES))
def test_kernel_check_rejects_domain_perturbations(case):
    """chip_smoke.py's check, at the limits of the case's dtype, accepts
    the plain outputs and rejects each perturbation of the domain's edges
    that applies (the partial last k tile dropped, rows past the last full
    q tile left as zeros, scores from the first 128 of head_dim, head_dim
    columns 128-255 left as zeros or copied from columns 0-127, at head_dim
    384-512 out's, the dQ's and dK/dV's last 128 columns left as zeros or
    copied from columns 0-127 and out's second column half summed without
    the last visible k tile, TF32 in place of f32, and in f32 P rounded to TF32
    before O, P^T and dS^T before dV and dK and dS before dQ, and the f32
    forward's and dK/dV's transposed B operands stale, from the wrong head
    (where there is another KV head), in TF32 alone or paired in another
    order than the fragments') through at least one output it changes."""
    sq, sk, causal, q_offset, dtype, d = PERTURBED_CASES[case]
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = ((torch.randn(1, s, h, d, generator=gen) * 0.5).to(dtype)
                   for s, h in ((sq, 2), (sk, 1), (sk, 1), (sq, 2)))
    out, lse = tfa._fwd_reference(q, k, v, causal, q_offset)
    delta = tfa._delta(out, do)
    ref = {"out": out, "lse": lse,
           "dq": tfa._dq_reference(q, k, v, lse, do, delta, causal,
                                   q_offset)}
    ref["dk"], ref["dv"] = tfa._dkv_reference(q, k, v, lse, do, delta,
                                              causal, q_offset)
    lim = smoke.limits(dtype)
    for name, want in ref.items():
        assert smoke.check(name, want, want, **lim)["ok"], name
    wrong = smoke.domain_perturbed(q, k, v, do, ref, delta, causal,
                                   q_offset)
    expect = set()
    if sk % 64 and sk > 64:
        expect.add("keys_past_last_full_tile_dropped")
    if sq % 64:
        expect.add("rows_past_last_full_tile_zero")
    if d > 128:
        expect |= {"scores_from_first_128_of_d", "d_cols_128_255_zero",
                   "d_cols_128_255_from_cols_0_127"}
    if d > 256:
        expect |= {"d_cols_last_128_zero", "d_cols_last_128_from_cols_0_127",
                   "out_second_half_without_last_k_tile"}
    if dtype == torch.float32:
        expect |= {"tf32", "tf32_register_operands", "transposed_stale",
                   "reduced_index_misordered", "tf32_transposed_operands"}
        if k.shape[2] > 1:
            expect.add("transposed_from_wrong_head")
    assert set(wrong) == expect
    for kind, outputs in wrong.items():
        ratios = {}
        for name, got in outputs.items():
            assert got.shape == ref[name].shape, (kind, name)
            ratios[name] = smoke.check(name, got, ref[name], **lim)["ratio"]
        assert max(ratios.values()) > 1, (kind, ratios)


@pytest.mark.parametrize("case", ["f32_512", "f32_ragged_noncausal",
                                  "bf16_384_q_offset", "fp16_512"])
def test_new_perturbations_rejected_through_their_own_output(case):
    """The perturbations of the column-half wgmma forward and dQ and of
    the 3xTF32 forward are rejected through the output they target, on its
    own: at head_dim 384-512, out's and dQ's last 128 columns left as zeros
    or copied from columns 0-127, and out's second column half summed
    without each q tile's last visible k tile (against the plain out and
    dQ); in f32, P rounded to TF32 before O += P V (against the plain out
    and against the float64 one)."""
    sq, sk, causal, q_offset, dtype, d = PERTURBED_CASES[case]
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = ((torch.randn(1, s, h, d, generator=gen) * 0.5).to(dtype)
                   for s, h in ((sq, 2), (sk, 1), (sk, 1), (sq, 2)))
    out, lse = tfa._fwd_reference(q, k, v, causal, q_offset)
    delta = tfa._delta(out, do)
    ref = {"out": out, "lse": lse,
           "dq": tfa._dq_reference(q, k, v, lse, do, delta, causal,
                                   q_offset)}
    ref["dk"], ref["dv"] = tfa._dkv_reference(q, k, v, lse, do, delta,
                                              causal, q_offset)
    lim = smoke.limits(dtype)
    wrong = smoke.domain_perturbed(q, k, v, do, ref, delta, causal,
                                   q_offset)
    targets = []
    if d > 256:
        targets += [(p, n) for p in ("d_cols_last_128_zero",
                                     "d_cols_last_128_from_cols_0_127")
                    for n in ("out", "dq")]
        targets.append(("out_second_half_without_last_k_tile", "out"))
    if dtype == torch.float32:
        targets.append(("tf32_register_operands", "out"))
        exact_out, _ = smoke.fwd_float64(q, k, v, causal, q_offset)
        got = wrong["tf32_register_operands"]["out"]
        assert smoke.check("out", got, exact_out, **lim)["ratio"] > 1
    assert targets
    for kind, name in targets:
        got, want = wrong[kind][name], ref[name]
        assert got.shape == want.shape, (kind, name)
        assert smoke.check(name, got, want, **lim)["ratio"] > 1, (kind, name)


def test_f32_limit_tells_tf32_from_f32():
    """The f32 limits accept an f32 result summed in another order and
    reject the same inputs rounded to TF32."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4096, generator=gen)
    assert smoke.check("out", x * (1 + 1e-7), x,
                       **smoke.limits(torch.float32))["ok"]
    rounded = smoke.tf32(x)
    assert not torch.equal(rounded, x)
    assert ((rounded.view(torch.int32) & 0x1FFF) == 0).all()
    assert not smoke.check("out", rounded, x,
                           **smoke.limits(torch.float32))["ok"]
