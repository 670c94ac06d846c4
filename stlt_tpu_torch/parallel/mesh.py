"""The grid of ranks: own copy of ``stlt_tpu/parallel/mesh.py`` for
``torch.distributed``.

JAX's mesh is a device array of shape (data, model, context) that GSPMD
shards over. Here each rank is one process on one device and runs its own
program, so a :class:`Mesh` is this rank's place in the same grid (data
outermost, context innermost, as ``make_mesh`` reshapes the device list)
and the process groups of its ``context`` ring (the ranks of its data and
model index), of its ``data`` replicas (the ranks of its model and context
index) and of its ``model`` group (the ranks of its data and context
index, over which the Megatron shards of ``parallel/sharding.py`` sum).
:func:`set_active_mesh` / :func:`active_context_mesh` are the registry the
sequence-sharded attention layers consult (``stlt_tpu/parallel/mesh.py:96-106``);
:func:`active_data_mesh` / :func:`clip_span` the one the dropout sites and
the train step consult under a data axis, and :func:`frame_span` /
:func:`frame_rows` the global frame rows of a ring rank's dropout sites;
:func:`active_model_mesh` the one the sharded layers consult.
:func:`all_sum`, :func:`broadcast` and :func:`all_gather` are the
collectives of all three, over one of the groups (no gradient);
:func:`model_sum` and :func:`model_copy` are Megatron's two operators of
the model group, with gradients: the row-parallel products' sum (backward
the identity) and the copy into the column-parallel layers (backward the
sum of the input's partial gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from stlt_tpu_torch.ops.dropout import RowMap

DATA_AXIS = "data"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"  # sequence parallelism over the frame axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model, context) grid: rank g sits at
    (g // (M C), g // C % M, g % C), g = (d M + m) C + c. ``ring_group``
    holds the C ranks of its (d, m), ``data_group`` the D ranks of its
    (m, c) and ``model_group`` the M ranks of its (d, c), each in rank
    order; None is the default process group, which a group is when it
    holds every rank (or its axis is 1 and it is never used)."""

    shape: Tuple[int, int, int]
    rank: int
    backend: str
    device: torch.device
    ring_group: Any = dataclasses.field(default=None, compare=False)
    data_group: Any = dataclasses.field(default=None, compare=False)
    model_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def data_index(self) -> int:
        return self.rank // (self.shape[1] * self.shape[2])

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank // self.shape[2] % self.shape[1]

    @property
    def context_size(self) -> int:
        return self.shape[2]

    @property
    def context_index(self) -> int:
        return self.rank % self.shape[2]

    def ring_rank(self, index: int) -> int:
        """The global rank of context index ``index`` of this rank's ring."""
        return self.rank - self.context_index + index % self.context_size

    def model_rank(self, index: int) -> int:
        """The global rank of model index ``index`` of this rank's model
        group."""
        return self.rank + (index % self.model_size - self.model_index) * self.context_size

    def first_clip(self, clips: int) -> int:
        """The global index of this rank's first clip in a forward of
        ``clips`` local clips (every data rank holds as many): its rows of
        the global batch, or of a global microbatch, are contiguous."""
        return self.data_index * clips


def check_batch(data: int, batch_size: int) -> None:
    """Every data rank takes an equal share of each global batch: refuse a
    ``batch_size`` the data axis does not divide, in the words of
    ``stlt_tpu/parallel/mesh.py:70-77`` (multi-process)."""
    if batch_size % data:
        raise ValueError(f"batch_size={batch_size} does not divide the data axis ({data}); in "
                         "multi-process mode every device must be used — raise batch_size or "
                         "change the mesh")


def grid_groups(data: int, model: int, context: int):
    """The rank lists of every ring (one per (d, m)), every data group (one
    per (m, c)) and every model group (one per (d, c)) of the grid, in
    that order, each list in rank order."""
    def rank(d, m, c):
        return (d * model + m) * context + c

    rings = [[rank(d, m, c) for c in range(context)] for d in range(data) for m in range(model)]
    replicas = [[rank(d, m, c) for d in range(data)] for m in range(model) for c in range(context)]
    models = [[rank(d, m, c) for m in range(model)] for d in range(data) for c in range(context)]
    return rings, replicas, models


def make_mesh(model_parallel: int = 1, context_parallel: int = 1,
              device: Optional[torch.device] = None, batch_size: Optional[int] = None) -> Mesh:
    """The grid over every rank of the initialised process group (one rank
    without one): data = world // (model_parallel * context_parallel). A
    ``batch_size`` the data axis does not divide raises
    (:func:`check_batch`). A family of groups (the rings, the data groups,
    the model groups) is made only when its groups have more than one rank
    and fewer than all: every rank then makes every group of the family, in
    :func:`grid_groups`' order (``dist.new_group`` is collective), and
    keeps its own."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    per_replica = model_parallel * context_parallel
    if model_parallel < 1 or context_parallel < 1 or world % per_replica:
        raise ValueError(f"model_parallel={model_parallel} x context_parallel={context_parallel} "
                         f"does not divide {world} processes")
    data = world // per_replica
    if batch_size is not None:
        check_batch(data, batch_size)
    own = []
    for family in grid_groups(data, model_parallel, context_parallel):
        mine = None
        if 1 < len(family[0]) < world:
            groups = [dist.new_group(ranks) for ranks in family]
            mine = next(g for g, ranks in zip(groups, family) if rank in ranks)
        own.append(mine)
    backend = dist.get_backend() if initialised else "none"
    return Mesh((data, model_parallel, context_parallel), rank, backend,
                torch.device("cpu") if device is None else device, *own)


def all_sum(x: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``mesh.ring_group``,
    ``mesh.data_group`` or ``mesh.model_group``; None: every rank), each rank getting the same bits,
    taken in f32 and returned in x's dtype; on gloo a device tensor is
    staged through host memory (gloo's collectives take CPU tensors). No
    gradient."""
    staged = x.device.type != "cpu" and mesh.backend != "nccl"
    buf = x.to("cpu" if staged else x.device, torch.float32, copy=True)  # f32: every backend sums it
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.device, x.dtype)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int, group=None) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group`` (None: every
    rank), the same shape and dtype on each; staged through host memory on
    gloo. No gradient."""
    staged = x.device.type != "cpu" and mesh.backend != "nccl"
    buf = x.to("cpu" if staged else x.device, copy=True).contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The ``x`` of every rank of ``group`` (the same shape on each; None:
    every rank), stacked in rank order on a new leading axis; staged
    through host memory on gloo."""
    staged = x.device.type != "cpu" and mesh.backend != "nccl"
    buf = x.to("cpu" if staged else x.device).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.stack(parts).to(x.device)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_sum(x, mesh, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.mesh, ctx.mesh.model_group), None


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of a row-parallel product's partials ``x`` over the model
    group (:func:`all_sum`: in f32, the same bits on every rank). The
    cotangent of the sum is the same on every rank and is each partial's
    own: the backward passes it through unchanged."""
    return _ModelSum.apply(x, mesh)


def model_copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, a replicated activation, as the input of a column-parallel
    layer (q/k/v, ``linear1``, ``fc1``). Each rank's cotangent of it is the
    part that the rank's columns give; the backward sums the parts over the
    model group (in f32), so x's gradient is the whole one on every rank
    and a replicated parameter upstream is not counted M times."""
    return _ModelCopy.apply(x, mesh)


# --- active-mesh registry ----------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_context_mesh() -> Optional[Mesh]:
    """The active mesh iff it has a context axis above 1 (else None)."""
    mesh = _ACTIVE_MESH
    if mesh is not None and mesh.context_size > 1:
        return mesh
    return None


def active_model_mesh() -> Optional[Mesh]:
    """The active mesh iff it has a model axis above 1 (else None): the
    sharded layers then sum their row-parallel products over its
    ``model_group`` and gather their column-parallel heads."""
    mesh = _ACTIVE_MESH
    if mesh is not None and mesh.model_size > 1:
        return mesh
    return None


def active_data_mesh() -> Optional[Mesh]:
    """The active mesh iff it has a data axis above 1 (else None)."""
    mesh = _ACTIVE_MESH
    if mesh is not None and mesh.data_size > 1:
        return mesh
    return None


def clip_span(clips: int) -> Tuple[int, int]:
    """(first, total) of a forward of ``clips`` local clips: the global
    index of this rank's first clip and the clips of the global batch (or
    microbatch) that all data ranks hold together; (0, clips) without a
    data axis. The dropout sites hash (or draw) their bits at these global
    clips, so N data ranks drop what one process drops."""
    mesh = active_data_mesh()
    if mesh is None:
        return 0, clips
    return mesh.first_clip(clips), mesh.data_size * clips


def frame_span(frames: int) -> Tuple[int, int]:
    """(first, total) of a forward of ``frames`` local frames: under a
    context mesh this ring rank's first frame of the clips and their whole
    frame axis (c t, C t), else (0, frames)."""
    mesh = active_context_mesh()
    if mesh is None:
        return 0, frames
    return mesh.context_index * frames, mesh.context_size * frames


def frame_rows(clips: int, frames: int) -> RowMap:
    """The global (clip, frame) row of local row ``b frames + j`` of a
    forward of ``clips`` clips of ``frames`` local frames, at which the
    dropout sites off the ring hash their bits: ``(clip0 + b) F + f0 + j``
    with ``(clip0, ...)`` = :func:`clip_span` and ``(f0, F)`` =
    :func:`frame_span`, the map of period ``frames`` and stride F (affine
    without a ring). The spatial encoder's rows and the temporal encoder's
    tokens are such rows; JAX's GSPMD step runs those sites on the global
    arrays and hashes them there."""
    clip0, _ = clip_span(clips)
    f0, total = frame_span(frames)
    return RowMap(clip0 * total + f0, frames, total)
