"""The grid of ranks: own copy of ``stlt_tpu/parallel/mesh.py`` for
``torch.distributed``.

JAX's mesh is a device array of shape (data, model, context) that GSPMD
shards over. Here each rank is one process on one device and runs its own
program, so a :class:`Mesh` is this rank's place in the same grid (data
outermost, context innermost, as ``make_mesh`` reshapes the device list)
and the process group of its ``context`` ring. :func:`set_active_mesh` /
:func:`active_context_mesh` are the registry the sequence-sharded attention
layers consult (``stlt_tpu/parallel/mesh.py:96-106``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"  # sequence parallelism over the frame axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model, context) grid. Only the context
    axis runs, so the ring is every rank of the default process group, in
    rank order: this rank's context index is its rank."""

    shape: Tuple[int, int, int]
    rank: int
    backend: str
    device: torch.device

    @property
    def context_size(self) -> int:
        return self.shape[2]

    @property
    def context_index(self) -> int:
        return self.rank


def make_mesh(model_parallel: int = 1, context_parallel: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The grid over every rank of the initialised process group (one rank
    without one): data = world // (model_parallel * context_parallel), rank
    g at (g // (M C), g // C % M, g % C). A data or model axis above 1
    raises with the ROADMAP.md item it waits for."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    per_replica = model_parallel * context_parallel
    if model_parallel < 1 or context_parallel < 1 or world % per_replica:
        raise ValueError(f"model_parallel={model_parallel} x context_parallel={context_parallel} "
                         f"does not divide {world} processes")
    data = world // per_replica
    if model_parallel > 1:
        raise NotImplementedError("the model axis (--model_parallel > 1) is not ported yet: it "
                                  "waits for ROADMAP.md item A9 (model axis)")
    if data > 1:
        raise NotImplementedError(f"{world} processes over a context axis of {context_parallel} "
                                  f"leave a data axis of {data}: the data axis is not ported yet, "
                                  f"it waits for ROADMAP.md item A9 (data axis)")
    backend = dist.get_backend() if initialised else "none"
    return Mesh((data, model_parallel, context_parallel), rank, backend,
                torch.device("cpu") if device is None else device)


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
