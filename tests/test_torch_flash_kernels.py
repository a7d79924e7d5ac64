"""The port's CUDA flash-attention kernels against their plain versions.

These need the card (a CUDA kernel has no host mode): each test carries
the ``gpu`` marker and skips where ``torch.cuda.is_available()`` is
false. The file imports no JAX, so it runs on the machine with the card:

    python -m pytest tests/test_torch_flash_kernels.py -q

bf16 inputs; each output is held to its plain version by chip_smoke.py's
``check``: every element within atol + 2e-2 |want|, with atol = min(2e-2,
1e-2 max|want|) scaled to that output, relative L2 within 1e-2, and lse
within 1e-3.
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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no host mode)")
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, sq, sk, h, hkv, _, _ = CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(*shape):
        return (torch.randn(*shape, generator=gen, device=device)
                * 0.5).bfloat16()
    return mk(b, sq, h, D), mk(b, sk, hkv, D), mk(b, sk, hkv, D), \
        mk(b, sq, h, D)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(case, cuda):
    *_, causal, q_offset = CASES[case]
    q, k, v, do = _inputs(case, cuda)
    out, lse = tfa._fwd_cuda(q, k, v, causal, q_offset)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, causal, q_offset)
    got = tfa._bwd_cuda(q, k, v, ref_out, ref_lse, do, causal, q_offset)
    want = tfa._bwd_reference(q, k, v, ref_out, ref_lse, do, causal,
                              q_offset)
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse, *got), (ref_out, ref_lse, *want)):
        result = smoke.check(name, g, w)
        assert result["ok"], (name, result)


def test_strided_inputs_read_through_strides(cuda):
    """q/k/v as views into wider [B, S, H, D] buffers (a slice of the
    sequence and of the heads) give the same result as contiguous copies."""
    q, k, v, do = _inputs("gqa_4_2", cuda)
    wide_q = torch.zeros(2, 384, 6, D, device=cuda, dtype=torch.bfloat16)
    wide_q[:, 64:320, 1:5] = q
    qv = wide_q[:, 64:320, 1:5]
    assert not qv.is_contiguous()
    out, lse = tfa._fwd_cuda(qv, k, v, True, 0)
    ref_out, ref_lse = tfa._fwd_cuda(q, k, v, True, 0)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)


def test_autograd_through_kernels_matches_reference_attention(cuda):
    """flash_attention on the card (kernels forward and backward) against
    the reference attention's autograd on repeated KV."""
    q, k, v, do = _inputs("gqa_4_2", cuda, seed=1)
    tfa.reset_launches()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    out.backward(do)
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    ref = [x.float().clone().requires_grad_() for x in (q, k, v)]
    ref_out = attention(ref[0], repeat_kv(ref[1], 2), repeat_kv(ref[2], 2))
    ref_out.backward(do.float())
    result = smoke.check("out", out, ref_out.detach())
    assert result["ok"], ("out", result)
    for name, a, b in zip("qkv", leaves, ref):
        result = smoke.check(f"d{name}", a.grad, b.grad)
        assert result["ok"], (f"d{name}", result)


def test_dispatch_and_refusals_on_card(cuda):
    """Auto dispatch sends f32 to the reference; the kernels refuse what
    they cannot take instead of computing it some other way."""
    q, k, v, _ = _inputs("gqa_4_2", cuda)
    tfa.reset_launches()
    tfa.best_attention(q.float(), k.float(), v.float())
    assert tfa.LAUNCHES["flash_fwd"] == 0
    tfa.best_attention(q, k, v)
    assert tfa.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="q_offset"):
        tfa._fwd_cuda(q, k, v, True, -64)
    with pytest.raises(ValueError, match="shapes disagree"):
        tfa._fwd_cuda(q, k, v[:, :64], True, 0)
    with pytest.raises(ValueError, match="multiples of 64"):
        tfa._fwd_cuda(q[:, :96], k, v, True, 0)
