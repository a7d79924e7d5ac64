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

The three kernels take their loaded operands from a prologue (the port's
``f32tc_split`` and ``f32tc_split_t`` are its plain versions): hi and lo
copies of Q, K, V and dO, and transposed copies V^T, K^T, dO^T and Q^T
whose S index is permuted within each group of 8 (PERM8), the order in
which a tensor-core fragment of the computed operand (P, P^T, dS^T, dS)
holds its keys or queries. The data-flow tests run the kernels' products
through those copies, with the computed operand split and put in fragment
order, and hold them to the plain 3xTF32 emulation above and to the
float64 versions. They must fail with 1xTF32, with the computed operands
unsplit, with the transposed copies' lo parts dropped, and with the
transposed copies left unpermuted. Each prologue's copy set, as
``f32tc_prologue`` returns it from the kernels' workspace, is held to those
plain versions.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.ops import flash_attention as tfa

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


def test_prologue_splits_and_permutes():
    """The plain prologue: hi and lo are TF32 values (low 13 bits zero)
    that sum to x within 2^-22 of it, and the transposed copy's position
    8g + c along S holds row 8g + PERM8[c] of x, both parts alike."""
    x = torch.tensor(np.random.default_rng(5).standard_normal((1, 16, 2, 64)),
                     dtype=torch.float32)
    parts = tfa.f32tc_split(x)
    assert parts.shape == (2, *x.shape)
    assert (parts.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((parts[0] + parts[1] - x).abs() <= x.abs() * 2.0 ** -22).all()
    assert sorted(tfa.PERM8) == list(range(8))
    t = tfa.f32tc_split_t(x)
    assert t.shape == (2, 1, 2, 64, 16)
    for pos in range(16):
        row = 8 * (pos // 8) + tfa.PERM8[pos % 8]
        assert torch.equal(t[:, 0, :, :, pos], parts[:, 0, row])


def fragment_order(x, dim):
    """x with its index along ``dim`` in the order a fragment of a computed
    operand holds it: position 8g + c is index 8g + PERM8[c]."""
    order = torch.arange(x.shape[dim]).view(-1, 8)[
        :, list(tfa.PERM8)].reshape(-1)
    return x.index_select(dim, order)


# Data-flow scheme -> whether the f32 limits accept it.
DATAFLOW = {"3xtf32": True, "1xtf32": False,
            "register_operands_unsplit": False,
            "transposed_lo_dropped": False,
            "transposed_unpermuted": False}


class Dataflow:
    """The forward's, dQ's and dK/dV's products as the kernels run them: the
    loaded operands from the prologue's copies ([2, ...]: hi, lo), the
    computed one split in registers and in fragment order, each product
    the sum of its parts' products (lo.hi + hi.lo + hi.hi, or hi.hi alone
    under 1xtf32)."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.terms = ([(0, 0)] if scheme == "1xtf32"
                      else [(1, 0), (0, 1), (0, 0)])

    def product(self, eq, a, b):
        out = None
        for i, j in self.terms:
            term = torch.einsum(eq, a[i], b[j])
            out = term if out is None else out + term
        return out

    def register(self, x, dim):
        """A computed operand as the kernel's fragments: split (hi, lo),
        or (tf32(x), 0) left unsplit; its reduced index in fragment
        order."""
        if self.scheme == "register_operands_unsplit":
            hi = tfa.tf32_round(x)
            parts = torch.stack((hi, torch.zeros_like(hi)))
        else:
            parts = tfa.f32tc_split(x)
        return fragment_order(parts, dim + 1)

    def transposed(self, x):
        """The prologue's transposed copy [2, B, H, D, S] of x [B, S, H, D]
        as the scheme has it."""
        if self.scheme == "transposed_unpermuted":
            return tfa.f32tc_split(x.permute(0, 2, 3, 1))
        t = tfa.f32tc_split_t(x)
        if self.scheme == "transposed_lo_dropped":
            t[1] = 0
        return t

    def dkv(self, q, k, v, do, lse, delta):
        """dK, dV of the dK/dV kernel (causal, q_offset 0): S^T = K Q^T and
        dP^T = V dO^T from the natural copies, dV += P^T dO^T-copy and dK
        += dS^T Q^T-copy, summed over the GQA group."""
        b, s, h, d = q.shape
        hkv = k.shape[2]
        g = h // hkv
        qs, dos, ks, vs = (tfa.f32tc_split(x) for x in (q, do, k, v))
        qt, dot = (self.transposed(x).reshape(2, b, hkv, g, d, s)
                   for x in (q, do))
        group = lambda x: x.reshape(2, b, s, hkv, g, d)
        scale = d ** -0.5
        st = self.product("btkd,bqkgd->bkgtq", ks, group(qs)) * scale
        st = st.masked_fill(torch.arange(s)[None, :] < torch.arange(s)[:, None],
                            NEG_INF)
        p = torch.exp(st - lse.reshape(b, hkv, g, 1, s))
        dpt = self.product("btkd,bqkgd->bkgtq", vs, group(dos))
        ds = p * (dpt - delta.reshape(b, hkv, g, 1, s)) * scale
        dv = self.product("bkgtq,bkgdq->btkd", self.register(p, 4), dot)
        dk = self.product("bkgtq,bkgdq->btkd", self.register(ds, 4), qt)
        return dk, dv

    def dq(self, q, k, v, do, lse, delta):
        """dQ of the dQ kernel (causal, q_offset 0): S = Q K^T and dP = dO
        V^T from the natural copies, then dQ += dS K^T-copy with dS the
        register operand."""
        b, s, h, d = q.shape
        hkv = k.shape[2]
        g = h // hkv
        qs, dos, ks, vs = (tfa.f32tc_split(x) for x in (q, do, k, v))
        kt = self.transposed(k)                      # [2, B, Hkv, D, S]
        group = lambda x: x.reshape(2, b, s, hkv, g, d)
        scale = d ** -0.5
        st = self.product("bqkgd,btkd->bkgqt", group(qs), ks) * scale
        st = st.masked_fill(torch.arange(s)[:, None] < torch.arange(s)[None, :],
                            NEG_INF)
        p = torch.exp(st - lse.reshape(b, hkv, g, s, 1))
        dp = self.product("bqkgd,btkd->bkgqt", group(dos), vs)
        ds = p * (dp - delta.reshape(b, hkv, g, s, 1)) * scale
        dq = self.product("bkgqt,bkdt->bqkgd", self.register(ds, 4), kt)
        return dq.reshape(q.shape)

    def fwd(self, q, k, v, block=64):
        """out, lse of the forward kernel (causal, q_offset 0): S = Q K^T
        from the natural copies, the online softmax over k tiles of
        ``block`` keys, O += P V^T-copy."""
        b, s, h, d = q.shape
        hkv = k.shape[2]
        g = h // hkv
        qs, ks = tfa.f32tc_split(q), tfa.f32tc_split(k)
        qs = qs.reshape(2, b, s, hkv, g, d)
        vt = self.transposed(v)                      # [2, B, Hkv, D, S]
        scale = d ** -0.5
        m = torch.full((b, hkv, g, s, 1), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros(b, hkv, g, s, d)
        queries = torch.arange(s)[:, None]
        for k0 in range(0, k.shape[1], block):
            st = self.product("bqkgd,btkd->bkgqt", qs,
                              ks[:, :, k0:k0 + block]) * scale
            keys = torch.arange(k0, k0 + st.shape[-1])[None, :]
            st = st.masked_fill(queries < keys, NEG_INF)
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            p = torch.exp(st - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + self.product("bkgqt,bkdt->bkgqd",
                                        self.register(p, 4),
                                        vt[..., k0:k0 + block])
            m = m_new
        out = (o / l).permute(0, 3, 1, 2, 4).reshape(q.shape)
        return out, (m + torch.log(l)).reshape(b, h, s)


@pytest.mark.parametrize("scheme", sorted(DATAFLOW))
def test_dkv_dataflow_through_prologue_copies(case, scheme):
    """dK and dV through the prologue's split, transposed and permuted
    copies equal the plain 3xTF32 emulation's and hold the f32 limits of
    the float64 version; a wrong scheme does not."""
    q, k, v, do, lse, delta = case
    want = smoke.dkv_float64(q, k, v, lse, do, delta, True, 0)
    inputs = [x.float() for x in (q, k, v, do, lse, delta)]
    got = Dataflow(scheme).dkv(*inputs)
    plain = dkv(*inputs, SCHEMES["3xtf32"][0])
    lim = smoke.limits(torch.float32)
    for name, g, w, pl in zip(("dk", "dv"), got, want, plain):
        assert g.dtype == torch.float32 and g.shape == w.shape
        result = smoke.check(name, g, w, **lim)
        if DATAFLOW[scheme]:
            assert result["ok"], (name, result)
            assert smoke.check(name, g, pl, **lim)["ok"], name
        else:
            assert result["ratio"] > 1, (name, result)


@pytest.mark.parametrize("scheme", sorted(DATAFLOW))
def test_fwd_dataflow_through_prologue_copies(case, scheme):
    """out and lse through the prologue's split copies and permuted V^T
    equal the plain 3xTF32 emulation's and hold the f32 limits of the
    float64 version; a wrong scheme gives an out they reject."""
    q, k, v, *_ = case
    want = smoke.fwd_float64(q, k, v, True, 0)
    inputs = [x.float() for x in (q, k, v)]
    got = Dataflow(scheme).fwd(*inputs)
    plain = fwd(*inputs, SCHEMES["3xtf32"][0])
    lim = smoke.limits(torch.float32)
    results = {n: smoke.check(n, g, w, **lim)
               for n, g, w in zip(("out", "lse"), got, want)}
    if DATAFLOW[scheme]:
        assert all(r["ok"] for r in results.values()), results
        for n, g, pl in zip(("out", "lse"), got, plain):
            assert smoke.check(n, g, pl, **lim)["ok"], n
    else:
        assert results["out"]["ratio"] > 1, results


@pytest.mark.parametrize("scheme", sorted(DATAFLOW))
def test_dq_dataflow_through_prologue_copies(case, scheme):
    """dQ through the prologue's split copies and its split, transposed and
    permuted K^T equals the plain 3xTF32 emulation's and holds the f32
    limits of the float64 version; a wrong scheme does not."""
    q, k, v, do, lse, delta = case
    want = smoke.dq_float64(q, k, v, lse, do, delta, True, 0)
    inputs = [x.float() for x in (q, k, v, do, lse, delta)]
    got = Dataflow(scheme).dq(*inputs)
    plain = dq(*inputs, SCHEMES["3xtf32"][0])
    lim = smoke.limits(torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    result = smoke.check("dq", got, want, **lim)
    if DATAFLOW[scheme]:
        assert result["ok"], result
        assert smoke.check("dq", got, plain, **lim)["ok"]
    else:
        assert result["ratio"] > 1, result


# The copies each kernel reads: the dQ's S = Q K^T and dP = dO V^T take Q,
# dO, K and V in rows, its dQ += dS K takes K^T.
PROLOGUE_COPIES = {"fwd": ("q", "k", "v_t"),
                   "dq": ("q", "do", "k", "v", "k_t"),
                   "dkv": ("q", "do", "q_t", "do_t", "k", "v")}


@pytest.mark.parametrize("kind", sorted(PROLOGUE_COPIES))
def test_prologue_copies_are_the_plain_splits(kind):
    """f32tc_prologue's copies of each kernel, read from a workspace laid
    out as the kernels' prologue writes it (the copies one after another, in
    F32TC_COPIES order; the dQ's 4 Sq H D + 6 Sk Hkv D floats), are
    f32tc_split of each operand and f32tc_split_t of the transposed ones, as
    chip_smoke.py's plain_copy names them; the dQ's K^T is K's transposed,
    permuted copy."""
    b, sq, sk, h, hkv, d = 1, 24, 16, 4, 2, 32
    rng = np.random.default_rng(3)
    q, do = (torch.tensor(rng.standard_normal((b, sq, h, d)),
                          dtype=torch.float32) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((b, sk, hkv, d)),
                         dtype=torch.float32) for _ in range(2))
    names = tfa.F32TC_COPIES[kind]
    assert names == PROLOGUE_COPIES[kind]
    plain = {n: smoke.plain_copy(n, q, k, v, do) for n in names}
    flat = torch.cat([plain[n].reshape(-1) for n in names])
    nq, nkv = b * sq * h * d, b * sk * hkv * d
    floats = {"fwd": 2 * nq + 4 * nkv, "dq": 4 * nq + 6 * nkv,
              "dkv": 8 * nq + 4 * nkv}
    assert flat.numel() == floats[kind]
    views = tfa.f32tc_views(kind, flat, b, h, hkv, sq, sk, d)
    assert list(views) == list(names)
    for n, view in views.items():
        assert view.data_ptr() >= flat.data_ptr(), n
        assert torch.equal(view, plain[n]), n
    if kind == "dq":
        assert torch.equal(views["k"], tfa.f32tc_split(k))
        assert torch.equal(views["k_t"], tfa.f32tc_split_t(k))
        assert views["k_t"].shape == (2, b, hkv, d, sk)


def test_f32_dq_entry_takes_its_workspace_where_the_forward_does():
    """The f32 dQ entry takes the wgmma dQ entry's arguments plus one
    workspace pointer just before the common tail, where every forward
    entry takes its own; the other families' dQ entries are unchanged."""
    tail = len(tfa._TAIL)
    f32 = tfa.entry_argtypes("dq", "_f32tc")
    wgmma = tfa.entry_argtypes("dq", "")
    assert len(f32) == len(wgmma) + 1
    assert f32[-tail - 1] is tfa._P
    assert f32[:-tail - 1] + f32[-tail:] == wgmma
    assert tfa.entry_argtypes("fwd", "_f32tc")[-tail - 1] is tfa._P
    for kind in tfa.KINDS:
        assert tfa.entry_argtypes(kind, "") == tfa._ARGTYPES[f"flash_{kind}"]
    assert tfa.entry_argtypes("dkv", "_f32tc") == tfa._ARGTYPES["flash_dkv"]
