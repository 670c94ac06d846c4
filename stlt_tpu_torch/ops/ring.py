"""Ring attention over the ``context`` axis: ``stlt_tpu/ops/ring.py``
(``_ring_forward`` :108-183, the custom VJP ``_ring_attn_fwd`` /
``_ring_attn_bwd`` :188-277, ``ring_attention`` :280-386) as a per-rank
program.

JAX runs the ring under ``shard_map`` over a global view; here every rank
runs its own program on its own shards. Rank ``idx`` of a context ring of C
ranks holds its ``t = T / C`` query frames and the home K/V chunk of the
same frames. At step j it holds chunk ``(idx - j) mod C`` and calls the
blockwise kernel (``ops/flash.py``, TPU row 8) once. Under a data axis
too (a grid of D rings of C ranks, ``parallel/mesh.py``) each ring is one
data index's C ranks: K and V move between the ring's global ranks, over
its own process group.

- lengths mode (``kv_lengths`` [B], the global live frame counts, with
  ``causal``): the kernel's ring-offset mode with ``offsets = (idx * t,
  chunk * s)``, so the causal and padding mask of the whole sequence is
  generated in place and no O(T^2) array exists;
- dense mode (``bias`` [b, 1, t, S]: this rank's query rows of a
  head-invariant bias, every key column): the bias columns of the held
  chunk, no offsets.

The steps' normalised outputs merge in f32 by ``logaddexp`` of their lse
(rows with no live key in a chunk come with lse -1e30 and weigh 0). K and V
move to the next rank of the ring through ``dist.batch_isend_irecv`` on
the ring's group: on
NCCL the device tensors go directly, on gloo (ranks that share a device, or
the CPU) through pinned host buffers, since gloo's point-to-point takes CPU
tensors only. Unlike JAX, the forward does not rotate after its last step
(JAX does, to overlap its merge); the result is the same.

Dropout: ``dropout_seed`` hashes keep bits in the kernel from a seed folded
with the rank's mesh coordinates and the chunk (``_device_seed``,
``_step_seed`` :79-94, on the port's ``lowbias32``), since the kernel
hashes local (t, s): every (data, model, context) coordinate, as JAX
folds them, so the bits are JAX's on the same grid. ``dropout_mask``
(this rank's rows [b, n|1, t, C s],
0/1) is made uint8 once (a bool or uint8 mask is read in place); each step
hands the kernel the held chunk's column view ``mask[..., cols]`` (JAX's
per-step slice, :337-364) with its strides, no copy, so the kernel's s is
the chunk-local key.

Gradients (``_RingAttention``, JAX's custom VJP): the forward saves this
rank's shards only (q, k, v, the output, the merged global lse) and no
rotated chunk. The backward runs the ring again: at step j, one
``flash.blockwise_attention_bwd`` call on the held chunk with the global
lse (so p = exp(z - lse) is the globally normalised probability and the
chunks' contributions add up) and one dsum = rowsum(dO o out) taken once
from the global output, with the same offsets, bias columns and step seed
as the forward's step, so it redraws the forward's keep bits. dq adds up at
home in f32; the f32 dk and dv accumulators travel with their chunk and
take C rotations, so each lands home whole (K and V skip the last one).

:func:`context_sum` carries the extract frame of a frame-sharded model to
every rank. Its backward passes the cotangent through unchanged: every rank
runs the head on the same sum and computes the same loss, so each rank's
contribution has the sum's cotangent, and an all-reduce there would count
the loss C times.

:func:`gather_frames` joins the ring's frame slices [b, t, ...] into the
whole frame axis [b, C t, ...] on every rank, in ring order: the fusion
models' layout stream, which their fusion blocks read whole (JAX's GSPMD
gathers the frame axis there). Everything after it runs replicated on the
ring's ranks, so each rank holds the same cotangent of the whole axis; the
backward hands back this rank's slice of it, with no sum (a sum would
count it C times).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from stlt_tpu_torch.ops import flash
from stlt_tpu_torch.ops.dropout import MASK32, lowbias32
from stlt_tpu_torch.parallel.mesh import Mesh, all_gather, all_sum

_NEG_INF = flash._NEG_INF


def _device_seed(mesh: Mesh, seed: int) -> int:
    """Per-rank base seed: every mesh coordinate folded in, so no two ranks
    share a hash lane (local (b, n, t) repeat across shards): ``dev = (data
    M + model) C + context`` (``stlt_tpu/ops/ring.py:79-87``), which is the
    rank itself (``Mesh``: data outermost, context innermost)."""
    return int(lowbias32((int(seed) & MASK32) ^ mesh.rank))


def _step_seed(seed_dev: int, chunk: int) -> int:
    """Per-step seed: each K/V chunk its own bits."""
    return int(lowbias32(seed_dev ^ chunk))


def _rotate(tensors, mesh: Mesh):
    """Send each tensor to the next rank of the ring and receive the
    previous rank's in its place (same shapes and dtypes): the ring's
    global ranks, over its group."""
    idx = mesh.context_index
    nxt, prv = mesh.ring_rank(idx + 1), mesh.ring_rank(idx - 1)
    staged = tensors[0].device.type != "cpu" and mesh.backend != "nccl"
    if staged:  # gloo: point-to-point on host copies
        sends = [t.to("cpu").pin_memory() for t in tensors]
        recvs = [torch.empty(t.shape, dtype=t.dtype).pin_memory() for t in tensors]
    else:
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
    # bf16 travels as its 16-bit words: point-to-point moves bytes.
    wire = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    ops = [dist.P2POp(dist.isend, wire(t), nxt, mesh.ring_group) for t in sends]
    ops += [dist.P2POp(dist.irecv, wire(t), prv, mesh.ring_group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


def _ring_forward(q, k, v, bias, mesh: Mesh, lengths, causal, dropout_mask, dropout_rate,
                  seed_dev):
    """The ring's steps on this rank: (out [b, t, n, d] in v's dtype, the
    merged lse [b, n, t] f32)."""
    b, t, n, d = q.shape
    C, idx = mesh.context_size, mesh.context_index
    o = torch.zeros((b, n, t, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, n, t), _NEG_INF, dtype=torch.float32, device=q.device)
    k_c, v_c = k, v
    for j in range(C):
        o_j, lse_j = flash.blockwise_attention(
            q, k_c, v_c, **_step_kwargs(q, k, bias, mesh, j, lengths, causal, dropout_mask,
                                         dropout_rate, seed_dev))
        lse_new = torch.logaddexp(lse, lse_j)
        o = o * torch.exp(lse - lse_new)[..., None] + \
            o_j.transpose(1, 2).to(torch.float32) * torch.exp(lse_j - lse_new)[..., None]
        lse = lse_new
        if j + 1 < C:
            k_c, v_c = _rotate([k_c, v_c], mesh)
    return o.transpose(1, 2).to(v.dtype), lse


def _step_kwargs(q, k, bias, mesh: Mesh, j: int, lengths, causal, dropout_mask, dropout_rate,
                 seed_dev) -> dict:
    """The blockwise keyword arguments of ring step ``j`` on this rank (the
    held chunk ``(idx - j) mod C``), the same in the forward and the
    backward: offsets (lengths mode) or the chunk's bias columns, and the
    step's seed or mask columns."""
    t, s = q.shape[1], k.shape[1]
    idx = mesh.context_index
    chunk = (idx - j) % mesh.context_size
    cols = slice(chunk * s, (chunk + 1) * s)
    kw = dict(dropout_rate=dropout_rate)
    if seed_dev is not None:
        kw["dropout_seed"] = _step_seed(seed_dev, chunk)
    elif dropout_mask is not None:
        kw["dropout_mask"] = dropout_mask[..., cols]
    if lengths is not None:
        kw.update(kv_lengths=lengths, causal=causal, offsets=(idx * t, chunk * s))
    else:
        kw.update(bias=bias[..., cols])
    return kw


class _RingAttention(torch.autograd.Function):
    """``_ring_attn``'s VJP (``_ring_attn_fwd`` / ``_ring_attn_bwd``): see the
    module docstring. ``cfg`` holds (bias, mesh, lengths, causal,
    dropout_mask, dropout_rate, seed_dev)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        out, lse = _ring_forward(q, k, v, *cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        bias, mesh, lengths, causal, dropout_mask, dropout_rate, seed_dev = ctx.cfg
        C, t = mesh.context_size, q.shape[1]
        dsum = flash._dsum(g, out, lengths, mesh.context_index * t)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_c, v_c = k, v
        for j in range(C):
            dq_j, dk_j, dv_j = flash.blockwise_attention_bwd(
                q, k_c, v_c, g, lse, dsum,
                **_step_kwargs(q, k, bias, mesh, j, lengths, causal, dropout_mask, dropout_rate,
                               seed_dev))
            dq += dq_j
            dk += dk_j
            dv += dv_j
            # The accumulators travel with their chunk, C rotations in all, so
            # each lands home; K and V skip the last one.
            if j + 1 < C:
                k_c, v_c, dk, dv = _rotate([k_c, v_c, dk, dv], mesh)
            elif C > 1:
                dk, dv = _rotate([dk, dv], mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    mesh: Mesh,
    *,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Sequence-parallel self-attention on this rank's shards. q, k, v:
    [b, t, n, d], the rank's frames of the whole [b, C t, n, d]. The bias
    comes in one of two forms: ``kv_lengths`` [b] (global live frame counts,
    with ``causal``), or ``bias`` [b, 1, t, C t] (or None for no bias), this
    rank's query rows. Returns [b, t, n, d] in v's dtype; when q, k or v
    needs a gradient, through ``_RingAttention``."""
    if dropout_mask is not None and dropout_seed is not None:
        raise ValueError("pass a dropout mask OR a dropout seed, not both")
    if bias is not None and kv_lengths is not None:
        raise ValueError("pass a dense bias OR kv_lengths (+ causal), not both")
    b, t, n, d = q.shape
    s = k.shape[1]
    C = mesh.context_size
    if dropout_mask is not None:
        flash.check_mask("ring_attention", dropout_mask, b, n, t, C * s)
        dropout_mask = flash.mask_bytes(dropout_mask.to(q.device))
    if kv_lengths is None:
        bias = torch.zeros((b, 1, t, C * s), dtype=torch.float32, device=q.device) if bias is None \
            else bias.to(torch.float32)
        if bias.dim() != 4 or bias.shape[1] != 1 or bias.shape[2:] != (t, C * s):
            raise ValueError(f"ring attention takes this rank's head-invariant bias rows "
                             f"[b, 1, {t}, {C * s}], got {tuple(bias.shape)}")
    seed_dev = _device_seed(mesh, dropout_seed) if dropout_seed is not None else None
    cfg = (bias, mesh, kv_lengths, causal, dropout_mask, dropout_rate, seed_dev)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RingAttention.apply(q, k, v, cfg)
    return _ring_forward(q, k, v, *cfg)[0]


class _ContextSum(torch.autograd.Function):
    """The sum over the ring (``parallel/mesh.all_sum`` over the ring's
    group, the same bits on each rank) whose backward passes the cotangent
    through unchanged (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_sum(x, mesh, mesh.ring_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def context_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ring (exact where one rank adds a value and the
    others zeros) whose backward is the identity."""
    return _ContextSum.apply(x, mesh)


class _GatherFrames(torch.autograd.Function):
    """The ring's frame slices joined in ring order (see the module
    docstring); the backward is this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.t = mesh, x.shape[1]
        # Any dtype travels as its bytes, which every backend gathers.
        wire = x.contiguous().view(torch.uint8)
        parts = all_gather(wire, mesh, mesh.ring_group).view(x.dtype)  # [C, b, t, ...]
        return parts.transpose(0, 1).flatten(1, 2)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.context_index * ctx.t
        return g[:, lo:lo + ctx.t], None


def gather_frames(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This ring rank's frames ``x`` [b, t, ...] and the other ranks' joined
    into the whole frame axis [b, C t, ...], the same on every rank of the
    ring; its backward is the rank's slice of the cotangent."""
    return _GatherFrames.apply(x, mesh)
