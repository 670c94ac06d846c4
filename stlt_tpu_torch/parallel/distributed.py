"""Several processes, one device each: own copy of
``stlt_tpu/parallel/distributed.py`` (``maybe_initialize`` :28-53,
``process_row_span`` :54-82, ``is_coordinator`` :129) on
``torch.distributed``.

``--num_processes N --process_id r --coordinator_address host:port``
starts ``torch.distributed`` over a TCP store at that address (a
``file://`` URL is taken as it is). Rank r runs on ``cuda:(r %
device_count)``; ``--platform cpu`` is the only way onto the CPU. The
backend follows the topology, never a failure: NCCL when the ranks sit on
distinct devices, gloo when they share one (NCCL refuses two ranks on one
GPU) or run on the CPU. The choice is logged on one line.
"""

from __future__ import annotations

import datetime
import logging
from typing import Tuple

import torch
import torch.distributed as dist

from stlt_tpu_torch.parallel.mesh import Mesh, check_batch

_TIMEOUT = datetime.timedelta(minutes=10)


def process_device(platform, rank: int) -> torch.device:
    """The device of rank ``rank``: the CPU with ``--platform cpu``, else
    ``cuda:(rank % device_count)``; raises without a CUDA device."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown --platform {platform!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass --platform cpu to run on the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(platform, world: int) -> Tuple[str, str]:
    """(backend, why) for ``world`` ranks placed by :func:`process_device`."""
    if platform == "cpu":
        return "gloo", "the ranks run on the CPU"
    devices = torch.cuda.device_count()
    if world > devices:
        return "gloo", f"{world} ranks share {devices} device(s)"
    return "nccl", f"{world} ranks on {world} distinct devices"


def maybe_initialize(args) -> bool:
    """Start ``torch.distributed`` if the flags ask for it; returns whether
    this run has several processes. Sets this rank's CUDA device."""
    num_processes = getattr(args, "num_processes", 0) or 0
    coordinator = getattr(args, "coordinator_address", None)
    if num_processes <= 1 and not coordinator:
        return False
    if num_processes <= 1 or not coordinator:
        raise ValueError("a multi-process run needs both --num_processes N > 1 and "
                         "--coordinator_address host:port")
    rank = getattr(args, "process_id", 0)
    if not 0 <= rank < num_processes:
        raise ValueError(f"--process_id {rank} is outside [0, {num_processes})")
    platform = getattr(args, "platform", None)
    device = process_device(platform, rank)
    backend, why = backend_for(platform, num_processes)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=rank,
                            timeout=_TIMEOUT)
    logging.getLogger(__name__).info(
        "distributed: rank %d of %d on %s, backend %s (%s)", rank, num_processes, device, backend, why)
    return True


def process_row_span(mesh: Mesh, global_batch_size: int) -> Tuple[int, int]:
    """[start, stop) of the global batch rows this rank holds: the data
    axis is outermost over the ranks, so data rank d holds the contiguous
    rows [d B / D, (d + 1) B / D); every context rank of a ring holds the
    whole batch. Raises for a batch the data axis does not divide."""
    check_batch(mesh.data_size, global_batch_size)
    per_rank = global_batch_size // mesh.data_size
    return mesh.data_index * per_rank, (mesh.data_index + 1) * per_rank


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if is_initialized():
        dist.barrier()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_coordinator() -> bool:
    return rank() == 0


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
