"""Ring attention: sequence parallelism over the ``sp`` mesh axis (port of
``tf_operator_tpu/ops/ring_attention.py``).

Each rank of the ``sp`` ring holds one block of the sequence. K/V blocks
travel around the ring, one hop a step (send to ring position r+1, receive
from r-1), while each rank folds its queries' attention over the block it
holds into an online softmax. Causality uses global positions: block i is
ring position i, so a whole block is visible to rank ``my`` exactly when
it came from ``src < my`` (the diagonal block is masked within).

Two rings, as in the JAX package:

- ``ring_attention``: the einsum ring (``:30-91``), pure PyTorch, with
  bf16 operands summed in f32 and the running (num, den, max) softmax;
  autograd differentiates it, hops included.
- ``ring_flash_attention``: the flash kernels per block
  (``ops/flash_attention.py``). The diagonal block runs the causal
  forward kernel; each of the n-1 hops runs it non-causally on the block
  received, and ``_merge_block`` folds the normalised (out, lse) in, with
  the visibility ``src < my`` as a mask (a masked block is launched all
  the same: every rank makes the same calls). Its backward
  (``_RingFlash``) runs the dQ and dK/dV kernels of every block against
  the final lse and δ = rowsum(dO·O); the f32 dK/dV accumulators travel
  with their blocks, and one last hop takes each home. On a CUDA tensor it
  launches the kernels or raises; on the CPU it runs their plain versions.

The public rings take this rank's block and the ``sp`` process group. Inside,
a ring is written over ``Ring``: a hop callable and the ring positions of
the *lanes* it drives, a lane being one rank's block. On a process group
(``Ring.of_group``) there is one lane, this rank's, and the hop is a
``batch_isend_irecv`` on the group. The private ``_ring_attention_lanes``
and ``_ring_flash_lanes`` take a list of lanes: stepped in lock step by a
hop that rotates the list, they run a whole ring on one device, which is
how the tests check it.

``ring_attention_sharded`` is JAX's ``shard_map`` of the ring
(``:94-139``): global q/k/v laid out with the batch over the data axes, the
sequence over ``sp`` and the heads over ``tp`` (``local_map``), the ring
run on each rank's block over the ``sp`` group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops.layers import NEG_INF, repeat_kv

# One payload a lane: the tensors it sends in one hop.
Lanes = List[Tuple[torch.Tensor, ...]]
# hop(lanes, reverse=False) -> what each lane receives: from ring position
# r-1 (r+1 when ``reverse``), in the same order.
Hop = Callable[..., Lanes]


class _Shift(torch.autograd.Function):
    """A hop over a process group that autograd differentiates: its
    backward is the hop the other way round."""

    @staticmethod
    def forward(ctx, hop, reverse, *payload):
        ctx.hop, ctx.reverse = hop, reverse
        return hop.shift(payload, reverse)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.hop.shift(grads, not ctx.reverse))


class GroupHop:
    """The hop of one rank on a process group: each tensor goes to ring
    position r+1 (r-1 when reversed) and the same-shaped tensor comes from
    r-1 (r+1), every send and receive of the hop posted together."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        self.next = dist.get_global_rank(group, (rank + 1) % size)
        self.prev = dist.get_global_rank(group, (rank - 1) % size)

    def shift(self, payload, reverse: bool) -> Tuple[torch.Tensor, ...]:
        dst, src = (self.prev, self.next) if reverse else (self.next,
                                                           self.prev)
        payload = [t.contiguous() for t in payload]
        received = [torch.empty_like(t) for t in payload]
        ops = [dist.P2POp(dist.isend, t, dst, self.group) for t in payload]
        ops += [dist.P2POp(dist.irecv, t, src, self.group) for t in received]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(received)

    def __call__(self, lanes: Lanes, reverse: bool = False) -> Lanes:
        (payload,) = lanes
        if torch.is_grad_enabled() and any(t.requires_grad for t in payload):
            return [_Shift.apply(self, reverse, *payload)]
        return [self.shift(payload, reverse)]


@dataclasses.dataclass(frozen=True)
class Ring:
    """A ring of ``size`` positions; ``ranks`` are the positions of the
    lanes this process steps, ``hop`` moves one payload a lane."""

    hop: Hop
    ranks: Tuple[int, ...]
    size: int

    @classmethod
    def of_group(cls, group: dist.ProcessGroup) -> "Ring":
        """This rank's lane on ``group``, the ring in group-rank order."""
        return cls(GroupHop(group), (dist.get_rank(group),),
                   dist.get_world_size(group))

    def sources(self, step: int) -> List[int]:
        """Where each lane's K/V block came from after ``step`` hops."""
        return [(r - step) % self.size for r in self.ranks]


def _hop(ring: Ring, *per_lane: List[torch.Tensor]) -> List[list]:
    """One hop of several tensors a lane; returns them per kind."""
    got = ring.hop([tuple(ts) for ts in zip(*per_lane)])
    return [list(ts) for ts in zip(*got)]


# ---------------------------------------------------------------------------
# The einsum ring
# ---------------------------------------------------------------------------

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.ProcessGroup, causal: bool = True
                   ) -> torch.Tensor:
    """Blockwise-softmax ring attention of this rank's block [B, S_blk, H,
    D] over ``group`` (k/v with the same heads: repeat GQA KV first);
    returns [B, S_blk, H, D]."""
    return _ring_attention_lanes([q], [k], [v], Ring.of_group(group),
                                 causal)[0]


def _ring_attention_lanes(qs: List[torch.Tensor], ks: List[torch.Tensor],
                          vs: List[torch.Tensor], ring: Ring,
                          causal: bool) -> List[torch.Tensor]:
    """``ring_attention`` of each lane's block; returns one output a lane."""
    b, s_blk, h, d = qs[0].shape
    scale = d ** -0.5
    dev = qs[0].device
    pos = torch.arange(s_blk, device=dev)
    nums = [torch.zeros((b, s_blk, h, d), dtype=torch.float32, device=dev)
            for _ in qs]
    dens = [torch.zeros((b, h, s_blk), dtype=torch.float32, device=dev)
            for _ in qs]
    ms = [torch.full((b, h, s_blk), NEG_INF, dtype=torch.float32,
                     device=dev) for _ in qs]
    for step in range(ring.size):
        if step:
            ks, vs = _hop(ring, ks, vs)
        for i, (my, src) in enumerate(zip(ring.ranks, ring.sources(step))):
            # bf16 operands, f32 sums (JAX's preferred_element_type).
            logits = torch.einsum("bshd,bthd->bhst", qs[i].float(),
                                  ks[i].float()) * scale
            if causal:
                keep = (my * s_blk + pos)[:, None] >= (src * s_blk + pos)
                logits = logits.masked_fill(~keep, NEG_INF)
            m_new = torch.maximum(ms[i], logits.amax(dim=-1))
            # Guard fully-masked rows: keep the max finite.
            m_safe = torch.clamp_min(m_new, NEG_INF / 2)
            p = torch.exp(logits - m_safe[..., None])
            corr = torch.exp(ms[i] - m_safe)
            pv = torch.einsum("bhst,bthd->bshd", p.to(vs[i].dtype).float(),
                              vs[i].float())
            # A block wholly in the future changes nothing. It is computed
            # and selected away (JAX's where), so that every hop stays in
            # the autograd graph and each rank's backward makes the same
            # hops as its neighbours'.
            keep_block = torch.tensor(src <= my or not causal, device=dev)
            nums[i] = torch.where(
                keep_block, nums[i] * corr.transpose(1, 2)[..., None] + pv,
                nums[i])
            dens[i] = torch.where(keep_block, dens[i] * corr + p.sum(-1),
                                  dens[i])
            ms[i] = torch.where(keep_block, m_safe, ms[i])
    outs = [(num / torch.clamp_min(den, 1e-30).transpose(1, 2)[..., None])
            .to(q_.dtype) for num, den, q_ in zip(nums, dens, qs)]
    return outs


# ---------------------------------------------------------------------------
# Ring flash: the flash kernels per block
# ---------------------------------------------------------------------------

def _merge_block(acc_o: torch.Tensor, acc_lse: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, visible: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one normalised block result (o [B, S, H, D], lse [B, H, S])
    into the running f32 (out, lse); a block not ``visible`` merges with
    weight exp(-1e30) = 0."""
    if not visible:
        lse = torch.full_like(acc_lse, NEG_INF)
        o = torch.zeros_like(acc_o)
    m = torch.maximum(acc_lse, lse)
    m_safe = torch.clamp_min(m, NEG_INF / 2)   # both masked: exp stays sane
    w_acc = torch.exp(acc_lse - m_safe)
    w_new = torch.exp(lse - m_safe)
    denom = torch.clamp_min(w_acc + w_new, 1e-30)
    row = lambda w: w.transpose(1, 2)[..., None]      # [B,H,S] -> [B,S,H,1]
    out = (acc_o * row(w_acc) + o.float() * row(w_new)) / row(denom)
    return out, m_safe + torch.log(denom)


def _visible(causal: bool, src: int, my: int) -> bool:
    """Whether an off-diagonal block from ``src`` is seen by ``my``."""
    return src < my if causal else True


def _ring_flash_fwd(qs, ks, vs, ring: Ring, causal: bool):
    """Per lane (out in q's dtype, lse [B, H, S] f32)."""
    accs = []
    for q, k, v in zip(qs, ks, vs):
        o, lse = fa._fwd(q, k, v, causal, 0)
        accs.append((o.float(), lse))
    for step in range(1, ring.size):
        ks, vs = _hop(ring, ks, vs)
        for i, (my, src) in enumerate(zip(ring.ranks, ring.sources(step))):
            o, lse = fa._fwd(qs[i], ks[i], vs[i], False, 0)
            accs[i] = _merge_block(*accs[i], o, lse,
                                   _visible(causal, src, my))
    return ([o.to(q.dtype) for (o, _), q in zip(accs, qs)],
            [lse.contiguous() for _, lse in accs])


def _ring_flash_bwd(qs, ks, vs, outs, lses, dos, deltas, ring: Ring,
                    causal: bool):
    """Per lane (dq, dk, dv): every block's dQ and dK/dV kernels against
    the final lse and ``deltas`` (δ = rowsum(dO·O) of the final output),
    the f32 dK/dV accumulators riding the ring with their blocks and taken
    home by one last hop."""
    dqs, dks, dvs = [], [], []
    for q, k, v, o, lse, do, delta in zip(qs, ks, vs, outs, lses, dos,
                                          deltas):
        dq, dk, dv = fa._bwd(q, k, v, o, lse, do, causal, 0, delta)
        dqs.append(dq.float())
        dks.append(dk.float())
        dvs.append(dv.float())
    for step in range(1, ring.size):
        ks, vs, dks, dvs = _hop(ring, ks, vs, dks, dvs)
        for i, (my, src) in enumerate(zip(ring.ranks, ring.sources(step))):
            dq, dk, dv = fa._bwd(qs[i], ks[i], vs[i], outs[i], lses[i],
                                 dos[i], False, 0, deltas[i])
            if _visible(causal, src, my):
                dqs[i] = dqs[i] + dq.float()
                dks[i] = dks[i] + dk.float()
                dvs[i] = dvs[i] + dv.float()
    if ring.size > 1:
        # n-1 hops leave each block's accumulator one hop from home.
        dks, dvs = _hop(ring, dks, dvs)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for dk, k in zip(dks, ks)],
            [dv.to(v.dtype) for dv, v in zip(dvs, vs)])


class _RingFlash(torch.autograd.Function):
    """Lanes' q, k, v (flattened, n each) -> their outputs."""

    @staticmethod
    def forward(ctx, ring, causal, *qkv):
        n = len(ring.ranks)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _ring_flash_fwd(list(qs), list(ks), list(vs), ring,
                                     causal)
        ctx.ring, ctx.causal = ring, causal
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n = len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * n:(i + 1) * n])
                                  for i in range(5))
        dos = [do.contiguous() for do in dos]
        deltas = [fa._delta(o, do) for o, do in zip(outs, dos)]
        dqs, dks, dvs = _ring_flash_bwd(qs, ks, vs, outs, lses, dos, deltas,
                                        ctx.ring, ctx.causal)
        return (None, None, *dqs, *dks, *dvs)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: dist.ProcessGroup, causal: bool = True
                         ) -> torch.Tensor:
    """Ring attention over the flash kernels of this rank's block [B,
    S_blk, H, D] over ``group`` (k/v may carry fewer heads, GQA). Raises
    where the kernels' ``flash_supported`` refuses the block (use
    ``ring_attention``)."""
    return _ring_flash_lanes([q], [k], [v], Ring.of_group(group), causal)[0]


def _ring_flash_lanes(qs: List[torch.Tensor], ks: List[torch.Tensor],
                      vs: List[torch.Tensor], ring: Ring,
                      causal: bool) -> List[torch.Tensor]:
    """``ring_flash_attention`` of each lane's block; returns one output a
    lane."""
    s_blk, h, d = qs[0].shape[1:]
    if not fa.flash_supported(s_blk, s_blk, d):
        raise ValueError(
            f"ring_flash_attention unsupported for block shape "
            f"{tuple(qs[0].shape)}; use the einsum ring (ring_attention, "
            "or ring_attention_sharded(impl='einsum'))")
    if h % ks[0].shape[2]:
        raise ValueError(f"GQA head counts must divide: q heads {h}, kv "
                         f"heads {ks[0].shape[2]}")
    return list(_RingFlash.apply(ring, causal, *qs, *ks, *vs))


# ---------------------------------------------------------------------------
# The sharded wrapper
# ---------------------------------------------------------------------------

def sequence_placements(mesh) -> list:
    """Placements of a [B, S, H, D] tensor inside the ring: the batch over
    the data axes, the sequence over ``sp``, the heads over ``tp``."""
    return [Shard(1) if name == "sp" else p for name, p in
            zip(mesh.mesh_dim_names, fa.attention_placements(mesh))]


def resolve_impl(impl: str, s_blk: int, head_dim: int, q_heads: int,
                 kv_heads: int) -> str:
    """JAX's ``impl="auto"``: the flash ring where the kernels take the
    block shape (and the GQA heads divide), else the einsum ring."""
    if impl == "auto":
        return ("flash" if fa.flash_supported(s_blk, s_blk, head_dim)
                and q_heads % kv_heads == 0 else "einsum")
    if impl not in ("flash", "einsum"):
        raise ValueError(f"unknown ring impl {impl!r}")
    return impl


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, causal: bool = True,
                           impl: str = "auto") -> DTensor:
    """Ring attention of global q/k/v [B, S, H, D] on ``mesh``: plain
    tensors (the same on every rank, which then get their gradients whole)
    or DTensors are laid out by ``sequence_placements`` and each rank runs
    the ring on its block over the ``sp`` group; the output is a DTensor
    laid out so. ``impl``: "flash", "einsum" or "auto" (``resolve_impl``);
    the einsum ring repeats GQA KV to full heads."""
    from torch.distributed.tensor.experimental import local_map

    sp = mesh.size(mesh.mesh_dim_names.index("sp"))
    impl = resolve_impl(impl, q.shape[1] // sp, q.shape[3], q.shape[2],
                        k.shape[2])
    if impl == "einsum" and k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, group), repeat_kv(v, group)
    placements = sequence_placements(mesh)

    def place(x):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, placements)

    inner = ring_flash_attention if impl == "flash" else ring_attention
    per_shard = local_map(
        functools.partial(inner, group=mesh.get_group("sp"), causal=causal),
        out_placements=placements, in_placements=(placements,) * 3,
        device_mesh=mesh)
    return per_shard(place(q), place(k), place(v))
