"""The 3xTF32 arithmetic of the f32 forward, dK/dV and dQ kernels,
emulated on the CPU.

``csrc/flash_attention_f32tc.cu`` does every product of the f32 forward,
dK/dV and dQ on TF32 tensor cores: each f32 operand x is split into hi =
tf32(x) and lo = tf32(x - hi), and a product is lo.hi + hi.lo + hi.hi
with f32 sums. The loaded operands (Q, K, V, dO) and the computed ones (P
in the forward, P^T and dS^T in the dK/dV, dS in the dQ) are split alike.
Here each such product runs as f32 einsums of TF32-rounded parts: a
product of two TF32 values is exact in f32. The forward is emulated with
its online softmax over 64-key blocks.

What this covers is the operand split, not the accumulator. The sums here
are ordinary f32 einsums, rounded to nearest. The tensor cores' f32
accumulator rounds toward zero instead, so a long sum kept there drifts
one way; the kernel keeps only short sums there for that reason (see its
header). That part of its arithmetic is checked on the card alone, where
chip_smoke.py holds the kernel to the f32 limits of the f32 plain version
and of a float64 version.

The case is f32, D=512, S=256, GQA 4:1, causal, made from a seed with
numpy. out and lse, dK and dV, and dQ, are held, with chip_smoke.py's
check at the f32 limits (1e-5), to chip_smoke.py's float64 versions. The
3xTF32 scheme must pass. 1xTF32 (hi.hi alone) must fail, and so must
3xTF32 that splits only the loaded operands and leaves the computed ones
(P, P^T and dS^T, or dS) in TF32.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.compute

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

B, S, H, HKV, D = 1, 256, 4, 1, 512
NEG_INF = -1e30


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), as f32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


def parts(x, split: bool):
    """x as its TF32 parts: (hi, lo) when split, else (hi,)."""
    hi = tf32(x)
    return (hi, tf32(x - hi)) if split else (hi,)


def tensor_core(eq, a, b, split_a=True, split_b=True):
    """einsum ``eq`` of f32 a and b as the tensor cores do it: a sum of
    products of TF32 parts, lo.hi + hi.lo + hi.hi (small terms first; the
    lo.lo term dropped), each in f32."""
    pa, pb = parts(a, split_a), parts(b, split_b)
    terms = [(1, 0), (0, 1), (0, 0)]
    out = None
    for i, j in terms:
        if i < len(pa) and j < len(pb):
            term = torch.einsum(eq, pa[i], pb[j])
            out = term if out is None else out + term
    return out


def dkv(q, k, v, do, lse, delta, product):
    """dK and dV of the TPU _dkv_kernel (causal, q_offset 0), every
    product through ``product(eq, a, b, register_operand)``: S^T = K Q^T,
    dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q summed over the GQA
    group. Works in q's dtype."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    dog = do.reshape(b, s, hkv, h // hkv, d)
    lse = lse.reshape(b, hkv, h // hkv, 1, s)
    delta = delta.reshape(b, hkv, h // hkv, 1, s)
    scale = d ** -0.5
    st = product("btkd,bqkgd->bkgtq", k, qg, False) * scale
    keys = torch.arange(s)[:, None]
    queries = torch.arange(s)[None, :]
    st = st.masked_fill(queries < keys, NEG_INF)
    p = torch.exp(st - lse)
    dpt = product("btkd,bqkgd->bkgtq", v, dog, False)
    ds = p * (dpt - delta) * scale
    dv = product("bkgtq,bqkgd->btkd", p, dog, True)
    dk = product("bkgtq,bqkgd->btkd", ds, qg, True)
    return dk, dv


def dq(q, k, v, do, lse, delta, product):
    """dQ of the TPU _dq_kernel (causal, q_offset 0), every product through
    ``product(eq, a, b, register_operand)``: S = Q K^T, dP = dO V^T, then
    dQ = dS K with dS the register operand. Works in q's dtype."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    dog = do.reshape(b, s, hkv, h // hkv, d)
    lse = lse.reshape(b, hkv, h // hkv, s, 1)
    delta = delta.reshape(b, hkv, h // hkv, s, 1)
    scale = d ** -0.5
    st = product("bqkgd,btkd->bkgqt", qg, k, False) * scale
    queries = torch.arange(s)[:, None]
    keys = torch.arange(s)[None, :]
    st = st.masked_fill(queries < keys, NEG_INF)
    p = torch.exp(st - lse)
    dp = product("bqkgd,btkd->bkgqt", dog, v, False)
    ds = p * (dp - delta) * scale
    return product("bkgqt,btkd->bqkgd", ds, k, True).reshape(q.shape)


def fwd(q, k, v, product, block=64):
    """out and lse of the TPU _fwd_kernel (causal, q_offset 0) as the f32
    forward kernel computes them: key blocks of ``block`` keys in order
    and an online softmax (running max m and sum l; O rescaled by exp(m_old
    - m) before the block's P V is added), every product through
    ``product(eq, a, b, register_operand)``: S = Q K^T, then O += P V with
    P the register operand. Works in q's dtype."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    scale = d ** -0.5
    m = torch.full((b, hkv, h // hkv, s, 1), NEG_INF, dtype=q.dtype)
    l = torch.zeros_like(m)
    o = torch.zeros(b, hkv, h // hkv, s, d, dtype=q.dtype)
    queries = torch.arange(s)[:, None]
    for k0 in range(0, k.shape[1], block):
        kb, vb = k[:, k0:k0 + block], v[:, k0:k0 + block]
        st = product("bqkgd,btkd->bkgqt", qg, kb, False) * scale
        keys = torch.arange(k0, k0 + kb.shape[1])[None, :]
        st = st.masked_fill(queries < keys, NEG_INF)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.exp(st - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + product("bkgqt,btkd->bkgqd", p, vb, True)
        m = m_new
    out = (o / l).permute(0, 3, 1, 2, 4).reshape(q.shape)
    return out, (m + torch.log(l)).reshape(b, h, s)


# Scheme -> (the product of (eq, a, b, register operand), whether the f32
# limits accept it).
SCHEMES = {
    "3xtf32": (lambda eq, a, b, reg: tensor_core(eq, a, b), True),
    "1xtf32": (lambda eq, a, b, reg: tensor_core(eq, a, b, False, False),
               False),
    "3xtf32_register_operands_in_tf32": (
        lambda eq, a, b, reg: tensor_core(eq, a, b, split_a=not reg), False),
}


@pytest.fixture(scope="module")
def case():
    """Seeded f64 inputs, and lse and delta of the f64 forward."""
    rng = np.random.default_rng(13)
    q = torch.tensor(rng.standard_normal((B, S, H, D)) * 0.5)
    k = torch.tensor(rng.standard_normal((B, S, HKV, D)) * 0.5)
    v = torch.tensor(rng.standard_normal((B, S, HKV, D)) * 0.5)
    do = torch.tensor(rng.standard_normal((B, S, H, D)))
    group = H // HKV
    kr, vr = k.repeat_interleave(group, 2), v.repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bthd->bhqt", q, kr) * D ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                       # [B, H, S]
    out = torch.einsum("bhqt,bthd->bqhd", torch.exp(s - lse[..., None]), vr)
    delta = (do * out).sum(-1).transpose(1, 2)             # [B, H, S]
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_3xtf32_scheme_holds_f32_limits(case, scheme):
    """The f32 kernel's 3xTF32 products give dK and dV within the f32
    limits of the float64 plain version; 1xTF32, or TF32 register
    operands, do not."""
    q, k, v, do, lse, delta = case
    want = smoke.dkv_float64(q, k, v, lse, do, delta, True, 0)
    product, accepted = SCHEMES[scheme]
    got = dkv(*(x.float() for x in (q, k, v, do, lse, delta)), product)
    lim = smoke.limits(torch.float32)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        result = smoke.check(name, g, w, **lim)
        if accepted:
            assert result["ok"], (name, result)
        else:
            assert result["ratio"] > 1, (name, result)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_3xtf32_dq_scheme_holds_f32_limits(case, scheme):
    """The f32 dQ kernel's 3xTF32 products give dQ within the f32 limits of
    the float64 plain version; 1xTF32, or dS left in TF32 before dS K, do
    not."""
    q, k, v, do, lse, delta = case
    want = smoke.dq_float64(q, k, v, lse, do, delta, True, 0)
    product, accepted = SCHEMES[scheme]
    got = dq(*(x.float() for x in (q, k, v, do, lse, delta)), product)
    assert got.dtype == torch.float32 and got.shape == want.shape
    result = smoke.check("dq", got, want, **smoke.limits(torch.float32))
    if accepted:
        assert result["ok"], result
    else:
        assert result["ratio"] > 1, result


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_3xtf32_fwd_scheme_holds_f32_limits(case, scheme):
    """The f32 forward kernel's 3xTF32 products under its online softmax
    give out and lse within the f32 limits of the float64 plain version;
    1xTF32, or P left in TF32 before O += P V, give an out they reject."""
    q, k, v, *_ = case
    want = smoke.fwd_float64(q, k, v, True, 0)
    product, accepted = SCHEMES[scheme]
    got = fwd(*(x.float() for x in (q, k, v)), product)
    lim = smoke.limits(torch.float32)
    results = {}
    for name, g, w in zip(("out", "lse"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        results[name] = smoke.check(name, g, w, **lim)
    if accepted:
        assert all(r["ok"] for r in results.values()), results
    else:
        assert results["out"]["ratio"] > 1, results
