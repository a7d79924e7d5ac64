"""The port's CUDA flash-attention kernels against their plain versions.

These need the card (a CUDA kernel has no host mode): each test carries
the ``gpu`` marker and skips where ``torch.cuda.is_available()`` is
false. The file imports no JAX, so it runs on the machine with the card:

    python -m pytest tests/test_torch_flash_kernels.py -q

Each output is held to its plain version by chip_smoke.py's ``check``
at the limits of its dtype (``limits``): bf16 and fp16, every element
within atol + 2e-2 |want|, with atol = min(2e-2, 1e-2 max|want|) scaled
to that output, relative L2 within 1e-2, and lse within 1e-3; f32 the
same with 1e-5 for each. ``CASES`` are the wgmma kernels' bf16, head_dim
128 cases at whole tiles; ``DOMAIN_CASES`` the rest of the TPU kernels'
domain (ragged lengths, fp16, f32, head_dim 256-512; in bf16 and fp16 all
three wgmma kernels, at 384-512 by column halves, ``flash_fwd_d384``,
``flash_dq_d384``, ``flash_dkv_d384`` and the same at 512; in f32 the
3xTF32 tensor-core kernels, ``flash_fwd_f32tc``, ``flash_dq_f32tc`` and
``flash_dkv_f32tc``).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from tf_operator_tpu_torch.ops import flash_attention as tfa
from tf_operator_tpu_torch.ops.layers import attention, repeat_kv

pytestmark = [pytest.mark.compute, pytest.mark.gpu]

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

D = 128
# (batch, q_seq, k_seq, heads, kv_heads, causal, q_offset)
CASES = {
    "causal": (2, 128, 128, 4, 4, True, 0),
    "non_causal": (1, 192, 128, 4, 4, False, 0),
    "gqa_4_2": (2, 256, 256, 4, 2, True, 0),
    "gqa_4_1": (1, 128, 128, 4, 1, True, 0),
    "q_offset": (1, 64, 192, 4, 2, True, 128),
    "q_offset_ragged": (1, 128, 192, 4, 2, True, 32),
    "odd_tiles": (1, 1088, 1088, 8, 2, True, 0),
    "unseen_k_tiles": (1, 1024, 2048, 4, 1, True, 0),
    "gqa_8_1": (1, 256, 256, 8, 1, True, 0),
}


# (batch, q_seq, k_seq, heads, kv_heads, causal, q_offset, dtype, head_dim)
DOMAIN_CASES = {
    "ragged_200": (1, 200, 200, 4, 2, True, 0, torch.bfloat16, 128),
    "ragged_q_offset": (1, 72, 200, 4, 2, True, 128, torch.bfloat16, 128),
    "ragged_2000": (1, 2000, 2000, 4, 1, True, 0, torch.bfloat16, 128),
    "s8": (2, 8, 8, 4, 2, True, 0, torch.bfloat16, 128),
    "fp16": (1, 256, 256, 4, 2, True, 0, torch.float16, 128),
    "fp16_ragged": (1, 200, 136, 4, 2, False, 0, torch.float16, 128),
    "f32": (1, 256, 256, 4, 2, True, 0, torch.float32, 128),
    "f32_ragged": (1, 72, 200, 4, 2, True, 128, torch.float32, 128),
    "f32_512_gqa_4_1": (1, 200, 200, 4, 1, True, 0, torch.float32, 512),
    "f32_256_q_offset": (1, 64, 192, 4, 2, True, 128, torch.float32, 256),
    "f32_384_unseen_k_tiles": (1, 256, 512, 4, 1, True, 0, torch.float32,
                               384),
    "bf16_256": (1, 200, 200, 4, 2, False, 0, torch.bfloat16, 256),
    "bf16_256_causal_gqa_4_1": (1, 256, 256, 4, 1, True, 0, torch.bfloat16,
                                256),
    "bf16_256_q_offset": (1, 64, 192, 4, 2, True, 128, torch.bfloat16, 256),
    "bf16_256_unseen_k_tiles": (1, 512, 1024, 4, 1, True, 0, torch.bfloat16,
                                256),
    "fp16_256_ragged_q_offset": (1, 72, 200, 4, 2, True, 128, torch.float16,
                                 256),
    "fp16_256_odd_tiles": (2, 1088, 1088, 8, 2, True, 0, torch.float16, 256),
    "fp16_384": (1, 136, 256, 4, 2, True, 0, torch.float16, 384),
    "bf16_512_s8": (2, 8, 8, 4, 4, True, 0, torch.bfloat16, 512),
    "bf16_512_causal_gqa_4_1": (1, 256, 256, 4, 1, True, 0, torch.bfloat16,
                                512),
    "fp16_384_q_offset": (1, 72, 200, 4, 2, True, 128, torch.float16, 384),
    "bf16_512_unseen_k_tiles": (1, 512, 1024, 4, 1, True, 0, torch.bfloat16,
                                512),
    "bf16_512_gqa_8_2": (1, 256, 256, 8, 2, True, 0, torch.bfloat16, 512),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no host mode)")
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, sq, sk, h, hkv, _, _, dtype, d = (
        (*CASES[case], torch.bfloat16, D) if case in CASES
        else DOMAIN_CASES[case])
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(*shape):
        return (torch.randn(*shape, generator=gen, device=device)
                * 0.5).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, hkv, d), mk(b, sk, hkv, d), \
        mk(b, sq, h, d)


def _hold_kernels_to_plain(case, causal, q_offset, cuda):
    """Every kernel output of ``case`` within check's limits of its plain
    version (the kernels run first, so no plain result can sit in the
    memory their outputs get); returns the kernels' dq, dk, dv."""
    q, k, v, do = _inputs(case, cuda)
    out, lse = tfa._fwd_cuda(q, k, v, causal, q_offset)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, causal, q_offset)
    got = tfa._bwd_cuda(q, k, v, ref_out, ref_lse, do, causal, q_offset)
    want = tfa._bwd_reference(q, k, v, ref_out, ref_lse, do, causal,
                              q_offset)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse, *got), (ref_out, ref_lse, *want)):
        result = smoke.check(name, g, w, **smoke.limits(q.dtype))
        assert result["ok"], (name, result)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(case, cuda):
    _, sq, sk, _, _, causal, q_offset = CASES[case]
    got = _hold_kernels_to_plain(case, causal, q_offset, cuda)
    # Keys no query row sees get exact zeros (the outputs are torch.empty).
    unseen = sq + q_offset if causal else sk
    for name, g in zip(("dk", "dv"), got[1:]):
        assert (g[:, unseen:] == 0).all(), name


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_domain_kernels_match_plain_versions(case, cuda):
    """Ragged lengths, fp16, f32 and head_dim 256-512: each kernel of a
    case is the one kernel_suffix picks for it, held to the plain
    versions; keys no query row sees get exact zeros."""
    _, sq, sk, _, _, causal, q_offset, dtype, d = DOMAIN_CASES[case]
    tfa.reset_launches()
    got = _hold_kernels_to_plain(case, causal, q_offset, cuda)
    assert tfa.LAUNCHES == smoke.counts(
        {n: 1 for n in smoke.launch_keys(dtype, d).values()})
    unseen = sq + q_offset if causal else sk
    for name, g in zip(("dk", "dv"), got[1:]):
        assert (g[:, unseen:] == 0).all(), name


def _strided_view(x, cuda):
    """x as a view into a wider [B, S, H, D] buffer (a slice of the
    sequence and of the heads)."""
    b, s, h, d = x.shape
    wide = torch.zeros(b, s + 128, h + 2, d, device=cuda, dtype=x.dtype)
    wide[:, 64:64 + s, 1:1 + h] = x
    view = wide[:, 64:64 + s, 1:1 + h]
    assert not view.is_contiguous()
    return view


@pytest.mark.parametrize("case", ["gqa_4_2", "bf16_512_gqa_8_2"])
def test_strided_inputs_read_through_strides(case, cuda):
    """q/k/v/do as views into wider buffers give the same out, lse, dq, dk
    and dv as contiguous copies, bit for bit (the wgmma kernels at 128 and,
    by column halves, at 512)."""
    q, k, v, do = _inputs(case, cuda)
    qv, kv, vv, dov = (_strided_view(x, cuda) for x in (q, k, v, do))
    out, lse = tfa._fwd_cuda(qv, kv, vv, True, 0)
    ref_out, ref_lse = tfa._fwd_cuda(q, k, v, True, 0)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
    delta = tfa._delta(ref_out, do)
    got = tfa._bwd_cuda(qv, kv, vv, ref_out, ref_lse, dov, True, 0, delta)
    want = tfa._bwd_cuda(q, k, v, ref_out, ref_lse, do, True, 0, delta)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("case", ["odd_tiles", "f32_512_gqa_4_1",
                                  "bf16_512_gqa_8_2"])
def test_dq_is_deterministic(case, cuda):
    """Two dQ launches on the same inputs (the wgmma kernel at 128 and, by
    column halves, at 512 with H=8, Hkv=2; the 3xTF32 f32 one) give
    bitwise-identical results (no atomics; every row is summed in a fixed
    k-tile order)."""
    q, k, v, do = _inputs(case, cuda)
    out, lse = tfa._fwd_reference(q, k, v, True, 0)
    delta = tfa._delta(out, do)
    first = tfa._dq_cuda(q, k, v, lse, do, delta, True, 0)
    second = tfa._dq_cuda(q, k, v, lse, do, delta, True, 0)
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["f32_512_gqa_4_1", "bf16_256_causal_gqa_4_1",
                                  "bf16_512_causal_gqa_4_1"])
def test_dkv_is_deterministic(case, cuda):
    """Two dK/dV launches (the 3xTF32 f32 kernel, the wgmma D=256 and D=512
    ones; at D=512 the GQA items are split over CTAs here, 4 splits on a
    132-SM card) give bitwise-identical results: the GQA sum runs inside
    one CTA, or its splits are added by one kernel, in a fixed order."""
    q, k, v, do = _inputs(case, cuda)
    out, lse = tfa._fwd_reference(q, k, v, True, 0)
    delta = tfa._delta(out, do)
    first = tfa._dkv_cuda(q, k, v, lse, do, delta, True, 0)
    second = tfa._dkv_cuda(q, k, v, lse, do, delta, True, 0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["gqa_4_2", "bf16_256",
                                  "fp16_256_ragged_q_offset",
                                  "bf16_512_gqa_8_2", "f32_512_gqa_4_1",
                                  "f32"])
def test_autograd_through_kernels_matches_reference_attention(case, cuda):
    """flash_attention on the card (kernels forward and backward) against
    the reference attention's autograd on repeated KV: bf16 at head_dim
    128, 256 and 512, fp16 at 256, f32 at 512 and 128 (the reference in
    f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _inputs(case, cuda, seed=1)
    causal, q_offset = (CASES[case] if case in CASES
                        else DOMAIN_CASES[case])[5:7]
    group = q.shape[2] // k.shape[2]
    tfa.reset_launches()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, q_offset=q_offset)
    out.backward(do)
    assert tfa.LAUNCHES == smoke.counts(
        {n: 1 for n in smoke.launch_keys(q.dtype, q.shape[3]).values()})
    ref = [x.float().clone().requires_grad_() for x in (q, k, v)]
    ref_out = attention(ref[0], repeat_kv(ref[1], group),
                        repeat_kv(ref[2], group), causal=causal,
                        q_offset=q_offset)
    ref_out.backward(do.float())
    lim = smoke.limits(q.dtype)
    result = smoke.check("out", out, ref_out.detach(), **lim)
    assert result["ok"], ("out", result)
    for name, a, b in zip("qkv", leaves, ref):
        result = smoke.check(f"d{name}", a.grad, b.grad, **lim)
        assert result["ok"], (f"d{name}", result)


@pytest.mark.parametrize("case", ["f32", "f32_512_gqa_4_1",
                                  "bf16_512_causal_gqa_4_1",
                                  "bf16_512_gqa_8_2"])
def test_fwd_is_deterministic(case, cuda):
    """Two launches of the forward on the same inputs (the 3xTF32 f32 one;
    the wgmma one at 512, by column halves, at H=4, Hkv=1 and H=8, Hkv=2)
    give bitwise-identical out and lse (each row's max, sum and O in one
    CTA, summed in a fixed k-tile order)."""
    q, k, v, _ = _inputs(case, cuda)
    first = tfa._fwd_cuda(q, k, v, True, 0)
    second = tfa._fwd_cuda(q, k, v, True, 0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_dispatch_and_refusals_on_card(cuda):
    """Auto dispatch launches a kernel for f32 as for bf16; the kernels
    refuse what they cannot take instead of computing it some other
    way."""
    q, k, v, _ = _inputs("gqa_4_2", cuda)
    tfa.reset_launches()
    tfa.best_attention(q.float(), k.float(), v.float())
    assert tfa.LAUNCHES["flash_fwd_f32tc"] == 1
    tfa.best_attention(q, k, v)
    assert tfa.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(ValueError, match="one dtype"):
        tfa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="bf16, fp16 or f32"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="q_offset"):
        tfa._fwd_cuda(q, k, v, True, -64)
    with pytest.raises(ValueError, match="shapes disagree"):
        tfa._fwd_cuda(q, k, v[:, :64], True, 0)
    with pytest.raises(ValueError, match="domain"):
        tfa._fwd_cuda(q[:, :100], k, v, True, 0)


# Shapes (q_seq, k_seq, head_dim) across the edge of the domain.
DISPATCH_SHAPES = [(sq, sk, d) for sq, sk in ((8, 8), (200, 2000), (4, 64),
                                              (100, 128), (64, 60))
                   for d in (64, 128, 256, 384, 512, 640)]
# The forward each dtype launches at each head_dim of the domain.
FWD_KERNEL = {(dtype, d): "flash_fwd_f32tc" if dtype == torch.float32
              else "flash_fwd" + ("" if d == 128 else f"_d{d}")
              for dtype in (torch.bfloat16, torch.float16, torch.float32)
              for d in (128, 256, 384, 512)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_best_attention_launches_exactly_in_domain(dtype, cuda):
    """On a CUDA tensor every shape in the domain launches a kernel (the
    forward of its family: bf16 and fp16 the wgmma one of their head_dim,
    flash_fwd_d384 and flash_fwd_d512 at 384-512) and every shape outside
    it launches none."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for sq, sk, d in DISPATCH_SHAPES:
        q = torch.randn(1, sq, 2, d, generator=gen, device=cuda).to(dtype)
        kv = torch.randn(1, sk, 1, d, generator=gen, device=cuda).to(dtype)
        tfa.reset_launches()
        out = tfa.best_attention(q, kv, kv, causal=False)
        torch.cuda.synchronize()
        assert out.shape == q.shape
        inside = tfa.flash_supported(sq, sk, d, dtype)
        want = smoke.counts({FWD_KERNEL[dtype, d]: 1} if inside else {})
        assert tfa.LAUNCHES == want, (sq, sk, d, tfa.LAUNCHES)
