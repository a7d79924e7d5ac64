"""Flash attention (forward + backward) over hand-written Hopper kernels.

Port of ``tf_operator_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels (``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) become the CUDA
kernels of ``csrc/flash_attention.cu``, built for ``sm_90a`` and bound by
ctypes (``ops/_build.py``). The forward is the custom op
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
``flash_supported`` go to ``ops.layers.attention``, as the JAX
``best_attention`` does.

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

# The CUDA kernels' tile: 64 query rows by 64 key rows, head_dim 128.
BLOCK = 64
HEAD_DIM = 128

# Launches of each kernel, counted by the wrapper where it launches it.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fit_block(seq: int) -> int:
    """The card's tile rule: the kernels use fixed ``BLOCK``-row tiles and
    do not mask a ragged edge, so a sequence tiles only as a positive
    multiple of ``BLOCK`` (returns the tile, or 0 when it does not fit)."""
    return BLOCK if seq >= BLOCK and seq % BLOCK == 0 else 0


def flash_supported(q_seq: int, k_seq: int, head_dim: int,
                    dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernels take these shapes (and ``dtype``, if given):
    both sequence lengths multiples of 64, head_dim exactly 128, bf16."""
    if dtype is not None and dtype != torch.bfloat16:
        return False
    return (_fit_block(q_seq) > 0 and _fit_block(k_seq) > 0
            and head_dim == HEAD_DIM)


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
    P is cast to v's dtype before P.V, as in the TPU kernel."""
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
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_I] * 9 + [_I, _I, _F, _P],
    "flash_dq": [_P] * 7 + [_I] * 5 + [_I] * 12 + [_I, _I, _F, _P],
    "flash_dkv": [_P] * 8 + [_I] * 5 + [_I] * 12 + [_I, _I, _F, _P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_operand(name: str, x: torch.Tensor,
                   device: torch.device) -> Tuple[int, int, int]:
    """Validate one [B, S, H, 128] bf16 operand on ``device`` (a CUDA
    device); return its strides."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got "
                         f"{x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernels take bf16 only; {name} is "
                         f"{x.dtype}")
    if x.dim() != 4 or x.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name} must be [B, S, H, {HEAD_DIM}], got "
                         f"{tuple(x.shape)}")
    sb, ss, sh, sd = x.stride()
    if sd != 1 or any(st % 8 or st >= 2 ** 31 for st in (sb, ss, sh)) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit head_dim stride, 16-byte "
                         f"aligned rows and int32 strides; got strides "
                         f"{x.stride()}")
    return sb, ss, sh


def _check_operands(q, k, v, q_offset, do=None):
    """Validate the kernels' operands; return (dims, flat strides)."""
    device = q.device if q.is_cuda else torch.device("cuda")
    operands = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        operands.append(("do", do))
    strides = [st for name, x in operands
               for st in _check_operand(name, x, device)]
    b, sq, h, _ = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or v.shape != k.shape or (
            do is not None and do.shape != q.shape):
        raise ValueError(f"operand shapes disagree: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}"
                         + ("" if do is None else f" do={tuple(do.shape)}"))
    if not flash_supported(sq, sk, HEAD_DIM):
        raise ValueError(f"flash kernels need sequence lengths that are "
                         f"multiples of {BLOCK}: q={tuple(q.shape)} "
                         f"k={tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"GQA head counts must divide: q heads {h}, kv "
                         f"heads {hkv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return (b, h, hkv, sq, sk), strides


def _raise_on(rc: int, name: str) -> None:
    """The C entries return cudaGetLastError(), or a negated CUresult when
    a TMA tensor map of an operand cannot be encoded."""
    if rc < 0:
        raise RuntimeError(f"{name}: TMA tensor map rejected an operand "
                           f"(CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _fwd_cuda(q, k, v, causal, q_offset):
    (b, h, hkv, sq, sk), strides = _check_operands(q, k, v, q_offset)
    out = torch.empty((b, sq, h, HEAD_DIM), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), lse.data_ptr(), b, h, hkv, sq,
                              sk, *strides, int(causal), q_offset,
                              HEAD_DIM ** -0.5, stream)
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _bwd_args(q, k, v, lse, do, delta, causal, q_offset):
    """Validated scalar arguments shared by the dQ and dK/dV entries."""
    (b, h, hkv, sq, sk), strides = _check_operands(q, k, v, q_offset, do)
    for name, row in (("lse", lse), ("delta", delta)):
        if (row.dtype != torch.float32 or tuple(row.shape) != (b, h, sq)
                or not row.is_contiguous() or row.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 [B, H, Sq] on "
                             f"{q.device}, got {row.dtype} "
                             f"{tuple(row.shape)}")
    return (b, h, hkv, sq, sk, *strides, int(causal), q_offset,
            HEAD_DIM ** -0.5)


def _dq_cuda(q, k, v, lse, do, delta, causal, q_offset):
    args = _bwd_args(q, k, v, lse, do, delta, causal, q_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def _dkv_cuda(q, k, v, lse, do, delta, causal, q_offset):
    args = _bwd_args(q, k, v, lse, do, delta, causal, q_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
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
    they take, else the reference (repeating GQA KV itself).
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
