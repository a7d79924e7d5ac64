"""Flash attention (forward + backward) over hand-written Hopper kernels.

Port of ``tf_operator_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) become CUDA
kernels built for ``sm_90a`` and bound by ctypes (``ops/_build.py``), over
the TPU kernels' whole domain (``flash_supported``: sequences of any
multiple of 8 from 8 up, head_dim 128, 256, 384 or 512, bf16, fp16 or
f32), in two families picked per kernel by (kind, dtype, head_dim)
(``kernel_suffix``):

- bf16 and fp16: the wgmma/TMA kernels of ``csrc/flash_attention.cu``, at
  head_dim 128 (the training step's case; launch keys ``flash_fwd``,
  ``flash_dq``, ``flash_dkv``), at 256 (``flash_fwd_d256``,
  ``flash_dq_d256``, ``flash_dkv_d256``) and at 384 and 512
  (``flash_fwd_d384``, ``flash_dq_d384``, ``flash_dkv_d384``,
  ``flash_fwd_d512``, ``flash_dq_d512``, ``flash_dkv_d512``: each
  warpgroup of the forward and the dQ, each CTA of the dK/dV, one half of
  head_dim's columns; the dK/dV's ``dkv_splits``);
- f32 at every head_dim: the tensor-core kernels of
  ``csrc/flash_attention_f32tc.cu`` (``flash_fwd_f32tc``,
  ``flash_dq_f32tc``, ``flash_dkv_f32tc``), whose products are 3xTF32
  (each f32 operand split into two TF32 parts), within f32's limits. All
  three are wgmma/TMA kernels, each fed by its prologue, which writes each
  operand's TF32 parts, and the transposed copies their products reduce
  over, into a workspace the wrapper allocates (``f32tc_split``,
  ``f32tc_split_t`` are its plain versions).

Both mask ragged sequence edges in the kernel. The forward is the custom op
``tf_operator_tpu_torch::flash_fwd`` returning ``(out, lse)``; its autograd
formula saves ``(q, k, v, out, lse)`` and launches the dQ and dK/dV
kernels, recomputing ``P = exp(S - lse)`` as the TPU kernels do, so no
attention matrix is ever stored.

Both kernel outputs are outputs of one op, as JAX makes them primal
outputs of its ``custom_vjp`` and names them ``flash_out``/``flash_lse``:
a selective-checkpoint policy (``models/llama.py``) saves them by op, so
the backward of a rematerialised block reuses them and never runs the
forward kernel again. ``checkpoint_name`` is the identity op that names
the post-rope q/k/v for the same policies. ``lse`` is non-differentiable
(JAX's ``_guard_lse_nondiff`` contract): differentiating through it
raises.

Beside each kernel sits its plain PyTorch version (``_fwd_reference``,
``_bwd_reference``) with the kernels' cast points. A tensor on the CPU goes
to the plain version; a CUDA tensor launches the kernel or raises. The one
dispatch is ``best_attention``: shapes or dtypes outside
``flash_supported`` (BERT's head_dim 64, decode's single rows, lengths
that are no multiple of 8) go to ``ops.layers.attention``, as the JAX
``best_attention`` does; everything inside it launches a kernel.

Layout is [B, S, H, D] at every public function; k/v may carry fewer heads
(GQA, H % Hkv == 0), read directly by the kernels and never repeated.

The op has no DTensor sharding rule, so it takes local tensors only: a
DTensor reaching ``flash_attention`` raises. ``flash_attention_sharded``
is JAX's ``shard_map`` of the kernel: it lays global q/k/v out with the
batch over the mesh's data axes and the heads over ``tp`` and runs
``flash_attention`` on each rank's local ``[B/dp, S, H/tp, D]`` shard
(``local_map``). Inside a tensor-parallel model (``parallel/sharding.py``)
the activations are local already and reach ``best_attention`` with the
rank's own heads. Where tp divides the query heads but not the KV heads,
the JAX ``best_attention`` falls back to the reference on the global
heads; the port's model runs the reference on its own heads there
(``models/llama.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops.layers import NEG_INF, attention, repeat_kv
from tf_operator_tpu_torch.parallel.mesh import batch_placements

# The wgmma kernels' tile rows: an internal tile, not a limit of the
# domain (a partial last tile is masked in the kernel).
BLOCK = 64
# The JAX package's default blocks and lane width, which its
# flash_supported judges shapes by (copied, not imported).
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
_LANES = 128
MAX_HEAD_DIM = 512
# Input dtypes the kernels take, with the C entries' codes for them.
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
# The library of each kernel family (by the suffix of its C entries).
_LIBRARY = {"": "flash_attention", "_f32tc": "flash_attention_f32tc"}
# Launch-key suffix of each variant -> its family: "_d256", "_d384" and
# "_d512" are the wgmma family at those head_dims, "_f32tc" the f32
# kernels on tensor cores. Every variant has all three kinds.
_FAMILY = {"": "", "_d256": "", "_d384": "", "_d512": "", "_f32tc": "_f32tc"}
KINDS = ("fwd", "dq", "dkv")
HEAD_DIMS = (128, 256, 384, 512)
# The wgmma dK/dV at head_dim 384-512 runs a CTA per (pair of 64-key
# tiles, KV head, batch, half of head_dim); where that grid is smaller than
# the card, each CTA's GQA items are split over up to this many CTAs,
# whose f32 partial sums a second kernel adds in a fixed order.
MAX_DKV_SPLITS = 4

# Launches of each kernel, counted by the wrapper where it launches it.
LAUNCHES: Dict[str, int] = {
    f"flash_{kind}{suffix}": 0 for suffix in _FAMILY for kind in KINDS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_suffix(kind: str, dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs ``kind`` ("fwd", "dq" or "dkv") for (dtype,
    head_dim) in the domain, as the suffix of its launch key: "" for the
    wgmma kernels at head_dim 128 (bf16 and fp16), "_d256", "_d384" and
    "_d512" for them at those head_dims, "_f32tc" for f32. Raises
    ValueError outside the domain."""
    if kind not in KINDS or head_dim not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"no flash kernel runs {kind!r} at {dtype}, "
                         f"head_dim {head_dim}")
    if dtype == torch.float32:
        return "_f32tc"
    return "" if head_dim == 128 else f"_d{head_dim}"


def dkv_splits(suffix: str, batch: int, k_seq: int, kv_heads: int,
               sms: int) -> int:
    """How many CTAs share the GQA items of one (key-tile pair, KV head,
    batch, column half) in the kernel of launch-key ``suffix`` on a card of
    ``sms`` SMs: 1 but for the wgmma dK/dV at 384-512, where it is as many
    as keep the grid within the card (at most MAX_DKV_SPLITS)."""
    if suffix not in ("_d384", "_d512"):
        return 1
    ctas = -(-k_seq // (2 * BLOCK)) * 2 * kv_heads * batch
    return max(1, min(MAX_DKV_SPLITS, sms // ctas))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fit_block(seq: int, want: int) -> int:
    """JAX's block rule: the largest 8-aligned block <= ``want`` that
    divides ``seq`` (8 when none does, 0 for a sequence under 8)."""
    b = min(want, seq)
    b -= b % 8
    while b > 8 and seq % b:
        b -= 8
    return b


def flash_supported(q_seq: int, k_seq: int, head_dim: int,
                    dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the kernels take these shapes (and ``dtype``, if given):
    exactly the JAX package's ``flash_supported`` at its default blocks
    (both lengths >= 8 and multiples of 8, head_dim a multiple of 128 up
    to 512), and a dtype of bf16, fp16 or f32."""
    if dtype is not None and dtype not in DTYPES:
        return False
    bq = _fit_block(q_seq, DEFAULT_BLOCK_Q)
    bk = _fit_block(k_seq, DEFAULT_BLOCK_K)
    if bq < 8 or bk < 8:
        return False
    return (q_seq % bq == 0 and k_seq % bk == 0
            and head_dim % _LANES == 0 and head_dim <= MAX_HEAD_DIM)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the golden the kernels are held to)
# ---------------------------------------------------------------------------

def _scores(q, k, causal, q_offset):
    """f32 scaled, masked scores [B, Hkv, G, Sq, Sk] (head h = hk*G + g)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * d ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        k_pos = torch.arange(sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    return s, qg


def _fwd_reference(q, k, v, causal: bool = True, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense forward: (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] f32).
    P is cast to v's dtype before P.V, as in the TPU kernel. Any dtype
    and head_dim."""
    b, sq, h, d = q.shape
    s, _ = _scores(q, k, causal, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out, lse


# The f32 kernels' prologue (csrc/flash_attention_f32tc.cu,
# flash_split_f32tc_kernel): each operand's TF32 parts, and the transposed
# copies whose S index is permuted within each group of 8 so that a
# tensor-core fragment column c meets accumulator column PERM8[c].
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: cvt.rna.tf32.f32), as f32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -8192).view(torch.float32)


def f32tc_split(x: torch.Tensor) -> torch.Tensor:
    """[2, *x.shape]: hi = tf32(x) and lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return torch.stack((hi, tf32_round(x.float() - hi)))


def f32tc_split_t(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D] (S a multiple of 8) as the prologue's transposed
    copy [2, B, H, D, S]: position 8g + c along S holds row 8g + PERM8[c],
    hi then lo."""
    b, s, h, d = x.shape
    order = (torch.arange(s, device=x.device).view(-1, 8)[
        :, list(PERM8)]).reshape(-1)
    return f32tc_split(x[:, order].permute(0, 2, 3, 1))


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32, [B, H, Sq] (the TPU's δ pre-pass)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs_grads(q, k, v, lse, do, delta, causal, q_offset):
    """Recompute P = exp(S - lse) and dS = P (dP - δ) scale (f32,
    [B, Hkv, G, Sq, Sk]) as the TPU backward kernels do."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    s, qg = _scores(q, k, causal, q_offset)
    p = torch.exp(s - lse.reshape(b, hkv, h // hkv, sq, 1))
    dog = do.float().reshape(b, sq, hkv, h // hkv, d)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1)) * d ** -0.5
    return p, ds, qg, dog


def _dq_reference(q, k, v, lse, do, delta, causal=True, q_offset=0):
    """Plain dQ = dS.K with dS cast to k's dtype (the _dq_kernel)."""
    _, ds, _, _ = _probs_grads(q, k, v, lse, do, delta, causal, q_offset)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(q.shape).to(q.dtype)


def _dkv_reference(q, k, v, lse, do, delta, causal=True, q_offset=0):
    """Plain dK = dS^T.Q and dV = P^T.dO summed over the GQA group, with
    P and dS cast to the input dtype (the _dkv_kernel)."""
    p, ds, qg, dog = _probs_grads(q, k, v, lse, do, delta, causal, q_offset)
    dv = torch.einsum("bkgqt,bqkgd->btkd", p.to(do.dtype).float(), dog)
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds.to(q.dtype).float(), qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_reference(q, k, v, out, lse, do, causal: bool = True,
                   q_offset: int = 0, delta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense backward from the saved lse (δ = rowsum(dO O) unless given)."""
    if delta is None:
        delta = _delta(out, do)
    dq = _dq_reference(q, k, v, lse, do, delta, causal, q_offset)
    dk, dv = _dkv_reference(q, k, v, lse, do, delta, causal, q_offset)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry ends (causal, q_offset, scale, dtype code, head_dim, stream);
# the forward entries take a workspace (the f32 kernel's; the wgmma
# forward takes none), the f32 dQ entry its workspace and the dK/dV
# entries (workspace, splits) before that. Keyed by entry: a family whose
# entry is not listed takes the wgmma family's form.
_TAIL = [_I, _I, _F, _I, _I, _P]
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_I] * 9 + [_P] + _TAIL,
    "flash_dq": [_P] * 7 + [_I] * 5 + [_I] * 12 + _TAIL,
    "flash_dq_f32tc": [_P] * 7 + [_I] * 5 + [_I] * 12 + [_P] + _TAIL,
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_I] * 12 + [_P, _I] + _TAIL,
}


def entry_argtypes(kind: str, family: str = "") -> list:
    """The ctypes argument types of the C entry ``flash_<kind><family>``."""
    name = f"flash_{kind}"
    return _ARGTYPES.get(name + family, _ARGTYPES[name])


# Kind codes of flash_f32tc_workspace.
_F32TC_KIND = {"fwd": 0, "dq": 1, "dkv": 2}


def _lib(family: str = "") -> ctypes.CDLL:
    """The built library of one kernel family, its entries typed."""
    lib = _build.load(_LIBRARY[family])
    for kind in KINDS:
        fn = getattr(lib, f"flash_{kind}{family}")
        fn.argtypes = entry_argtypes(kind, family)
        fn.restype = ctypes.c_int
    return lib


# The copies each f32 kernel's prologue writes (F32TC_COPIES[kind]), in
# the order of its workspace: a name ending "_t" is the transposed copy of
# the operand it starts with (``f32tc_split_t``), any other that
# operand's split (``f32tc_split``).
F32TC_COPIES = {"fwd": ("q", "k", "v_t"),
                "dq": ("q", "do", "k", "v", "k_t"),
                "dkv": ("q", "do", "q_t", "do_t", "k", "v")}


def f32tc_prologue(kind: str, q, k, v, do=None) -> Dict[str, torch.Tensor]:
    """The f32 forward's ("fwd"), dQ's ("dq") or dK/dV's ("dkv") prologue
    alone, on CUDA tensors: the copies its kernel reads, by the names of
    ``F32TC_COPIES[kind]``, each [2, ...] (hi, lo) as ``f32tc_split`` or
    ``f32tc_split_t`` computes them. Not on the main path (the kernels'
    entries launch it themselves): for timing it apart and checking its
    copies on the card."""
    (b, h, hkv, sq, sk), strides, (_, d) = _check_operands(
        q, k, v, 0, None if kind == "fwd" else do)
    if kind == "fwd":
        strides = strides + [0, 0, 0]
    ws = _f32tc_workspace(kind, q, k)
    entry = _lib("_f32tc").flash_prologue_f32tc
    entry.argtypes = [_I] + [_P] * 4 + [_I] * 17 + [_P, _I, _P]
    entry.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = entry(_F32TC_KIND[kind], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), None if do is None else do.data_ptr(),
                   b, h, hkv, sq, sk, *strides, ws.data_ptr(), d,
                   torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, f"flash_prologue_f32tc({kind})")
    return f32tc_views(kind, ws.view(torch.float32), b, h, hkv, sq, sk, d)


def f32tc_views(kind: str, flat: torch.Tensor, b: int, h: int, hkv: int,
                sq: int, sk: int, d: int) -> Dict[str, torch.Tensor]:
    """The copies of ``kind``'s prologue as views of its workspace ``flat``
    (f32), one after another in the order of ``F32TC_COPIES[kind]``:
    [2, B, S, H, D] splits and [2, B, H, D, S] transposed copies, the
    q side's at (Sq, H), the k side's at (Sk, Hkv)."""
    copies, at = {}, 0
    for name in F32TC_COPIES[kind]:
        s, heads = (sq, h) if name[:1] in "qd" else (sk, hkv)
        shape = ((2, b, heads, d, s) if name.endswith("_t")
                 else (2, b, s, heads, d))
        n = 2 * b * s * heads * d
        copies[name] = flat[at:at + n].view(shape)
        at += n
    return copies


def _f32tc_workspace(kind: str, q, k) -> torch.Tensor:
    """The f32 forward's, dQ's or dK/dV's workspace (its prologue's
    copies) for these operands, as the library sizes it."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    size = _lib("_f32tc").flash_f32tc_workspace
    size.argtypes, size.restype = [_I] * 7, ctypes.c_longlong
    nbytes = size(_F32TC_KIND[kind], b, h, hkv, sq, sk, d)
    return torch.empty(nbytes, dtype=torch.uint8, device=q.device)


def _entry(kind: str, suffix: str):
    """The C entry that launches kernel ``flash_<kind><suffix>``."""
    family = _FAMILY[suffix]
    return getattr(_lib(family), f"flash_{kind}{family}")


def _check_operand(name: str, x: torch.Tensor, device: torch.device,
                   dtype: torch.dtype, head_dim: int) -> Tuple[int, int, int]:
    """Validate one [B, S, H, head_dim] operand of ``dtype`` on ``device``
    (a CUDA device); return its strides."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != dtype:
        raise ValueError(f"the flash kernels take q, k, v and dO of one "
                         f"dtype; q is {dtype}, {name} is {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != head_dim:
        raise ValueError(f"{name} must be [B, S, H, {head_dim}], got "
                         f"{tuple(x.shape)}")
    sb, ss, sh, sd = x.stride()
    align = 16 // x.element_size()
    if sd != 1 or any(st % align or st >= 2 ** 31 for st in (sb, ss, sh)) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit head_dim stride, 16-byte "
                         f"aligned rows and int32 strides; got strides "
                         f"{x.stride()}")
    return sb, ss, sh


def _check_operands(q, k, v, q_offset, do=None):
    """Validate the kernels' operands; return (dims, flat strides, dtype
    code and head_dim)."""
    device = q.device if q.is_cuda else torch.device("cuda")
    if q.dtype not in DTYPES:
        raise ValueError(f"the flash kernels take bf16, fp16 or f32; q is "
                         f"{q.dtype}")
    d = q.shape[-1]
    operands = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        operands.append(("do", do))
    strides = [st for name, x in operands
               for st in _check_operand(name, x, device, q.dtype, d)]
    b, sq, h, _ = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or v.shape != k.shape or (
            do is not None and do.shape != q.shape):
        raise ValueError(f"operand shapes disagree: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}"
                         + ("" if do is None else f" do={tuple(do.shape)}"))
    if not flash_supported(sq, sk, d):
        raise ValueError(f"outside the flash kernels' domain (sequence "
                         f"lengths >= 8 and multiples of 8, head_dim 128, "
                         f"256, 384 or 512): q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"GQA head counts must divide: q heads {h}, kv "
                         f"heads {hkv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return (b, h, hkv, sq, sk), strides, (_DTYPE_CODE[q.dtype], d)


def _raise_on(rc: int, name: str) -> None:
    """The C entries return cudaGetLastError(), or a negated CUresult when
    a TMA tensor map of an operand cannot be encoded."""
    if rc < 0:
        raise RuntimeError(f"{name}: TMA tensor map rejected an operand "
                           f"(CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _fwd_cuda(q, k, v, causal, q_offset):
    (b, h, hkv, sq, sk), strides, (code, d) = _check_operands(
        q, k, v, q_offset)
    suffix = kernel_suffix("fwd", q.dtype, d)
    name = "flash_fwd" + suffix
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # The f32 kernel's prologue copies go to a workspace of its own.
    ws = (_f32tc_workspace("fwd", q, k) if _FAMILY[suffix] == "_f32tc"
          else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry("fwd", suffix)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, hkv, sq, sk, *strides,
            None if ws is None else ws.data_ptr(), int(causal),
            q_offset, d ** -0.5, code, d, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out, lse


def _bwd_args(kind, q, k, v, lse, do, delta, causal, q_offset):
    """Validated scalar arguments shared by the dQ and dK/dV entries, and
    the launch-key suffix of ``kind``'s kernel."""
    (b, h, hkv, sq, sk), strides, (code, d) = _check_operands(
        q, k, v, q_offset, do)
    for name, row in (("lse", lse), ("delta", delta)):
        if (row.dtype != torch.float32 or tuple(row.shape) != (b, h, sq)
                or not row.is_contiguous() or row.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B, H, Sq] on "
                             f"{q.device}, got {row.dtype} "
                             f"{tuple(row.shape)}")
    return (b, h, hkv, sq, sk, *strides, int(causal), q_offset, d ** -0.5,
            code, d), kernel_suffix(kind, q.dtype, d)


def _dq_cuda(q, k, v, lse, do, delta, causal, q_offset):
    args, suffix = _bwd_args("dq", q, k, v, lse, do, delta, causal,
                             q_offset)
    name = "flash_dq" + suffix
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # The f32 kernel's prologue copies, passed before the common tail.
    ws = (_f32tc_workspace("dq", q, k) if _FAMILY[suffix] == "_f32tc"
          else None)
    tail = len(_TAIL) - 1                  # the common tail, less the stream
    with torch.cuda.device(q.device):
        rc = _entry("dq", suffix)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args[:-tail],
            *([] if ws is None else [ws.data_ptr()]), *args[-tail:],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dq


def _dkv_cuda(q, k, v, lse, do, delta, causal, q_offset):
    args, suffix = _bwd_args("dkv", q, k, v, lse, do, delta, causal,
                             q_offset)
    name = "flash_dkv" + suffix
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    b, sk, hkv, _ = k.shape
    splits = dkv_splits(suffix, b, sk, hkv, _sm_count(q.device.index))
    # The splits' f32 partial dK and dV: [2, splits, B, Sk, Hkv, D]; the
    # f32 kernel's prologue copies.
    ws = (torch.empty((2, splits, *k.shape), dtype=torch.float32,
                      device=q.device) if splits > 1 else
          _f32tc_workspace("dkv", q, k) if _FAMILY[suffix] == "_f32tc"
          else None)
    tail = len(_TAIL) - 1                  # the common tail, less the stream
    with torch.cuda.device(q.device):
        rc = _entry("dkv", suffix)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args[:-tail], None if ws is None else ws.data_ptr(), splits,
            *args[-tail:], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return dk, dv


def _bwd_cuda(q, k, v, out, lse, do, causal, q_offset, delta=None):
    if delta is None:
        delta = _delta(out, do)
    dq = _dq_cuda(q, k, v, lse, do, delta, causal, q_offset)
    dk, dv = _dkv_cuda(q, k, v, lse, do, delta, causal, q_offset)
    return dq, dk, dv


def _fwd(q, k, v, causal, q_offset):
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, q_offset)
    return _fwd_reference(q, k, v, causal, q_offset)


def _bwd(q, k, v, out, lse, do, causal, q_offset, delta=None):
    if q.is_cuda:
        return _bwd_cuda(q, k, v, out, lse, do, causal, q_offset, delta)
    return _bwd_reference(q, k, v, out, lse, do, causal, q_offset, delta)


@torch.library.custom_op("tf_operator_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of one flash forward: the kernel on a CUDA tensor, the
    plain version on the CPU. Both contiguous, as the kernel writes them
    (the plain version's ``out`` may come out of its reshape permuted)."""
    out, lse = _fwd(q, k, v, causal, q_offset)
    return out.contiguous(), lse.contiguous()


@_flash_fwd_op.register_fake
def _(q, k, v, causal, q_offset):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.q_offset = causal, q_offset
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, out, lse, do.contiguous(), ctx.causal,
                      ctx.q_offset)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)


@torch.library.custom_op("tf_operator_tpu_torch::checkpoint_name",
                         mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that names ``x`` for a selective-checkpoint policy (JAX's
    ``jax.ad_checkpoint.checkpoint_name``). A custom op may not return its
    input, so this is a copy."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)

# The ops a selective-checkpoint policy saves for each JAX name.
FLASH_FWD_OP = torch.ops.tf_operator_tpu_torch.flash_fwd.default
CHECKPOINT_NAME_OP = torch.ops.tf_operator_tpu_torch.checkpoint_name.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Flash attention over [B, S, H, D] (k/v may be [B, T, Hkv, D] with
    H % Hkv == 0). Requires ``flash_supported`` shapes on any device, and
    local tensors (``flash_attention_sharded`` takes DTensors)."""
    if any(isinstance(x, DTensor) for x in (q, k, v)):
        raise TypeError("flash_attention takes local tensors, not DTensors "
                        "(the kernels have no sharding rule); use "
                        "flash_attention_sharded")
    if not flash_supported(q.shape[1], k.shape[1], q.shape[3]):
        raise ValueError(
            f"flash_attention unsupported for shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)}; use ops.layers.attention")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA head counts must divide: q heads "
                         f"{q.shape[2]}, kv heads {k.shape[2]}")
    out, _ = _flash_fwd_op(q, k, v, causal, q_offset)
    return out


def attention_placements(mesh):
    """Placements of a [B, S, H, D] tensor on ``mesh``: the batch over the
    data axes, the heads over ``tp``, the sequence whole."""
    return [Shard(2) if name == "tp" else p
            for name, p in zip(mesh.mesh_dim_names, batch_placements(mesh))]


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh, causal: bool = True,
                            q_offset: int = 0) -> DTensor:
    """Flash attention of global q/k/v on ``mesh``, one kernel call a rank
    on its local shard (JAX's ``shard_map`` over the kernel): plain tensors
    (the same on every rank, which then get their gradients whole) or
    DTensors are laid out by ``attention_placements``, and the output is a
    DTensor laid out so. Both head counts must divide the ``tp`` size,
    the batch the data axes'."""
    from torch.distributed.tensor.experimental import local_map

    placements = attention_placements(mesh)

    def place(x):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements)

    per_shard = local_map(
        functools.partial(flash_attention, causal=causal, q_offset=q_offset),
        out_placements=placements, in_placements=(placements,) * 3,
        device_mesh=mesh)
    return per_shard(place(q), place(k), place(v))


def best_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0,
                   force_flash: bool = False) -> torch.Tensor:
    """Dispatch: the CUDA kernels for CUDA tensors whose shapes and dtype
    are in their domain (``flash_supported``), else the reference
    (repeating GQA KV itself), as the JAX ``best_attention`` sends to
    Pallas or to XLA.
    ``force_flash`` always takes ``flash_attention`` (the plain version on
    the CPU), so unsupported shapes raise instead of falling back."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"GQA head counts must divide: q heads "
                         f"{q.shape[2]}, kv heads {k.shape[2]}")
    if force_flash or (q.is_cuda and flash_supported(
            q.shape[1], k.shape[1], q.shape[3], q.dtype)):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    group = q.shape[2] // k.shape[2]
    return attention(q, repeat_kv(k, group), repeat_kv(v, group),
                     causal=causal, q_offset=q_offset)
