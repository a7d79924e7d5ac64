"""Port parity: the port's flash attention against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain versions, and the JAX side
runs its kernels in interpret mode (as tests/test_flash_attention.py
does). Same numpy inputs, D = 128: forward within 2e-5, gradients within
5e-4. The CUDA kernels themselves are held against the plain versions by
tests/test_torch_flash_kernels.py, which runs only where there is a card.
"""

import ctypes
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import flash_attention as jfa
from tf_operator_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.compute

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

D = 128
# (batch, q_seq, k_seq, heads, kv_heads, causal, q_offset)
CASES = {
    "causal": (2, 128, 128, 4, 4, True, 0),
    "non_causal": (1, 128, 128, 4, 4, False, 0),
    "gqa_4_2": (2, 128, 128, 4, 2, True, 0),
    "gqa_4_1": (1, 128, 128, 4, 1, True, 0),
    "q_offset": (1, 64, 128, 4, 2, True, 64),
    "odd_tiles": (1, 192, 192, 4, 2, True, 0),
    "unseen_k_tiles": (1, 64, 192, 4, 2, True, 0),
}


def _inputs(case, seed=0):
    b, sq, sk, h, hkv, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, sk, hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, sk, hkv, D)) * 0.5).astype(np.float32)
    do = rng.standard_normal((b, sq, h, D)).astype(np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal, q_offset):
    """JAX kernel outputs in [B, H, S, *] layout: (out, lse [B, H, S])."""
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    out, lse = jfa._fwd(qt, kt, vt, causal, q_offset,
                        jfa._fit_block(q.shape[1], jfa.DEFAULT_BLOCK_Q),
                        jfa._fit_block(k.shape[1], jfa.DEFAULT_BLOCK_K), True)
    return np.asarray(out), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case):
    *_, causal, q_offset = CASES[case]
    q, k, v, _ = _inputs(case)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, q_offset=q_offset,
                               interpret=True)
    got = tfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal,
                              q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    _, want_lse = _jax_fwd(q, k, v, causal, q_offset)
    _, got_lse = tfa._fwd_reference(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), causal, q_offset)
    assert got_lse.shape == want_lse.shape
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    *_, causal, q_offset = CASES[case]
    q, k, v, do = _inputs(case, seed=1)

    def loss(a, b_, c):
        return jnp.sum(jfa.flash_attention(a, b_, c, causal=causal,
                                           q_offset=q_offset, interpret=True)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    (out * torch.tensor(do)).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_bwd_impl_given_lse_and_delta(case):
    """The plain backward, fed JAX's own lse and δ, equals _bwd_impl."""
    *_, causal, q_offset = CASES[case]
    q, k, v, do = _inputs(case, seed=2)
    out, lse = _jax_fwd(q, k, v, causal, q_offset)         # [B,H,S,*]
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    lse8 = jnp.broadcast_to(jnp.asarray(lse)[..., None], lse.shape + (8,))
    want = jfa._bwd_impl(t(q), t(k), t(v), jnp.asarray(out), lse8, t(do),
                         causal, q_offset,
                         jfa._fit_block(q.shape[1], jfa.DEFAULT_BLOCK_Q),
                         jfa._fit_block(k.shape[1], jfa.DEFAULT_BLOCK_K),
                         True)
    out_bshd = out.transpose(0, 2, 1, 3)
    delta = (do * out_bshd).sum(-1).transpose(0, 2, 1)     # [B,H,S]
    got = tfa._bwd_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(out_bshd), torch.tensor(lse), torch.tensor(do),
        causal, q_offset, delta=torch.tensor(np.ascontiguousarray(delta)))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).transpose(0, 2, 1, 3), atol=5e-4,
            rtol=5e-4, err_msg=f"d{name}")


def test_bf16_forward_close_to_jax():
    q, k, v, _ = _inputs("gqa_4_2")
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)), interpret=True)
    got = tfa.flash_attention(*(torch.tensor(x).bfloat16()
                                for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_flash_supported_gate():
    # The TPU kernels' domain: lengths >= 8 in multiples of 8, head_dim a
    # multiple of 128 up to 512; bf16, fp16 and f32.
    assert tfa.flash_supported(2048, 2048, 128)
    assert tfa.flash_supported(64, 192, 128, torch.bfloat16)
    for dtype in (torch.float32, torch.float16):
        assert tfa.flash_supported(2048, 2048, 128, dtype)
    assert not tfa.flash_supported(2048, 2048, 128, torch.float64)
    assert tfa.flash_supported(200, 2000, 512)         # ragged, wide
    assert tfa.flash_supported(8, 8, 384)
    assert not tfa.flash_supported(100, 128, 128)     # no multiple of 8
    assert not tfa.flash_supported(128, 4, 128)       # shorter than 8
    assert not tfa.flash_supported(128, 128, 64)      # head_dim
    assert not tfa.flash_supported(128, 128, 640)
    assert tfa._fit_block(2000, 512) == 400 and tfa._fit_block(4, 512) == 0
    bad = torch.zeros(1, 100, 2, D)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(bad, bad, bad)


# The kernel of each (kind, dtype, head_dim) of the domain, by launch-key
# suffix: the wgmma kernels for bf16/fp16, all three kinds, at 128 and at
# 256, 384 and 512 ("_d256", "_d384", "_d512"); the 3xTF32 tensor-core
# kernels for f32, all three kinds at every head_dim ("_f32tc").
WGMMA = {(kind, dtype, d): "" if d == 128 else f"_d{d}"
         for kind in ("fwd", "dq", "dkv")
         for dtype in ("bfloat16", "float16") for d in (128, 256, 384, 512)}
WGMMA.update({(kind, "float32", d): "_f32tc"
              for kind in ("fwd", "dq", "dkv")
              for d in (128, 256, 384, 512)})


@pytest.mark.parametrize("d", [128, 256, 384, 512])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_kernel_dispatch_table(kind, dtype, d):
    """Each kernel of each domain case goes to its own family, and its
    launch key is one of LAUNCHES'."""
    suffix = tfa.kernel_suffix(kind, getattr(torch, dtype), d)
    assert suffix == WGMMA[(kind, dtype, d)]
    assert f"flash_{kind}{suffix}" in tfa.LAUNCHES


@pytest.mark.parametrize("dtype, d", [(torch.int8, 128), (torch.bfloat16, 64),
                                      (torch.float32, 640)])
def test_kernel_suffix_refuses_outside_the_domain(dtype, d):
    """No kernel is named for a dtype or head_dim outside the domain: the
    dispatch raises instead of naming a fallback."""
    for kind in ("fwd", "dq", "dkv"):
        with pytest.raises(ValueError, match="no flash kernel"):
            tfa.kernel_suffix(kind, dtype, d)


def test_best_attention_dispatch_on_cpu():
    """CPU tensors take the reference unless flash is forced; both agree
    with JAX's best_attention; indivisible GQA heads raise."""
    q, k, v, _ = _inputs("gqa_4_2")
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    want = np.asarray(jfa.best_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v)))
    for force in (False, True):
        got = tfa.best_attention(tq, tk, tv, force_flash=force)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    short = torch.zeros(1, 4, 2, D)                   # decode-like shape
    assert tfa.best_attention(short, short, short).shape == short.shape
    with pytest.raises(ValueError, match="GQA head counts"):
        tfa.best_attention(tq, torch.zeros(2, 128, 3, D),
                           torch.zeros(2, 128, 3, D))


def test_kernel_wrappers_refuse_host_tensors():
    """The CUDA wrappers launch or raise: a host tensor is refused before
    any build, never computed some other way."""
    q, k, v, do = (torch.tensor(x).bfloat16() for x in _inputs("causal"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._fwd_cuda(q, k, v, True, 0)
    lse = torch.zeros(2, 4, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._dq_cuda(q, k, v, lse, do, lse, True, 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._dkv_cuda(q, k, v, lse, do, lse, True, 0)


def test_launch_counters_reset():
    tfa.LAUNCHES["flash_fwd"] += 3
    tfa.reset_launches()
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_fwd_d256": 0, "flash_dq_d256": 0,
                            "flash_dkv_d256": 0, "flash_fwd_d384": 0,
                            "flash_dq_d384": 0, "flash_dkv_d384": 0,
                            "flash_fwd_d512": 0, "flash_dq_d512": 0,
                            "flash_dkv_d512": 0, "flash_fwd_f32tc": 0,
                            "flash_dq_f32tc": 0, "flash_dkv_f32tc": 0}


# (launch-key suffix, batch, k_seq, kv_heads, SMs) -> splits
DKV_SPLITS = {
    ("_d512", 1, 2048, 8, 132): 1,   # 256 CTAs: the card is full
    ("_d512", 1, 2048, 4, 132): 1,   # 128 CTAs
    ("_d512", 1, 2048, 2, 132): 2,   # d512_train's heads: 64 CTAs
    ("_d384", 1, 2000, 2, 132): 2,   # 16 tile pairs, the last a single
    ("_d512", 1, 200, 8, 132): 4,    # 32 CTAs, capped at MAX_DKV_SPLITS
    ("_d384", 2, 8, 1, 132): 4,
    ("_d512", 1, 2048, 2, 64): 1,    # a smaller card
    ("_d256", 1, 200, 1, 132): 1,    # other kernels never split
    ("_f32tc", 1, 200, 1, 132): 1,
    ("", 1, 2048, 2, 132): 1,
}


@pytest.mark.parametrize("args", sorted(DKV_SPLITS))
def test_dkv_splits(args):
    """The wide wgmma dK/dV splits its GQA items over as many CTAs as keep
    its grid (2 column halves a pair of 64-key tiles, KV head and batch)
    within the card, up to MAX_DKV_SPLITS; no other kernel splits."""
    assert tfa.dkv_splits(*args) == DKV_SPLITS[args]
    assert 1 <= DKV_SPLITS[args] <= tfa.MAX_DKV_SPLITS


@pytest.mark.parametrize("family", sorted(tfa._LIBRARY))
def test_lib_types_only_the_family_s_own_kinds(family, monkeypatch):
    """_lib looks up and types the C entries of the family's own kinds
    (forward, dQ and dK/dV, under the family's suffix) and no other
    family's. A stub stands in for the built library (no card, no nvcc):
    like a ctypes.CDLL it raises AttributeError for an entry it lacks."""
    own = [f"flash_{kind}{family}" for kind in tfa.KINDS]

    class StubLib:
        def __init__(self):
            self.entries = {name: types.SimpleNamespace() for name in own}
            self.asked = []

        def __getattr__(self, name):
            self.asked.append(name)
            if name not in self.entries:
                raise AttributeError(name)
            return self.entries[name]

    stub = StubLib()
    monkeypatch.setattr(tfa._build, "load",
                        lambda name: stub if name == tfa._LIBRARY[family]
                        else None)
    assert tfa._lib(family) is stub
    assert stub.asked == own
    for kind in tfa.KINDS:
        entry = stub.entries[f"flash_{kind}{family}"]
        assert entry.argtypes == tfa.entry_argtypes(kind, family)
        assert entry.restype is ctypes.c_int
    suffixes = [sfx for sfx, fam in tfa._FAMILY.items() if fam == family]
    for sfx in suffixes:
        for kind in tfa.KINDS:
            assert tfa._entry(kind, sfx) is stub.entries[
                f"flash_{kind}{family}"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_check_rejects_wrong_outputs(case):
    """chip_smoke.py's kernel check, which holds each CUDA kernel to its
    plain version, accepts bf16 rounding noise and rejects zeros, a dropped
    δ, a skipped first or last k or q tile (the last k tile in the forward
    and dQ, the last q tile in dK/dV and in dQ's rows) and a GQA member
    left out of dK/dV (ratio > 1)."""
    *_, causal, q_offset = CASES[case]
    q, k, v, do = (torch.tensor(x).bfloat16() for x in _inputs(case))
    out, lse = tfa._fwd_reference(q, k, v, causal, q_offset)
    delta = tfa._delta(out, do)
    ref = {"out": out, "lse": lse,
           "dq": tfa._dq_reference(q, k, v, lse, do, delta, causal,
                                   q_offset)}
    ref["dk"], ref["dv"] = tfa._dkv_reference(q, k, v, lse, do, delta,
                                              causal, q_offset)
    for name, want in ref.items():
        noisy = want if name == "lse" else \
            (want.float() * (1 + 2 ** -8)).bfloat16()
        assert smoke.check(name, noisy, want)["ok"], name
    wrong = smoke.perturbed(q, k, v, do, ref, delta, causal, q_offset)
    assert set(wrong) == {"zeros", "delta_dropped", "first_k_tile_skipped",
                          "first_q_tile_skipped", "last_k_tile_skipped",
                          "last_q_tile_skipped", "gqa_member_dropped"}
    for kind, outputs in wrong.items():
        for name, got in outputs.items():
            assert got.shape == ref[name].shape, (kind, name)
            assert smoke.check(name, got, ref[name])["ratio"] > 1, (kind, name)
