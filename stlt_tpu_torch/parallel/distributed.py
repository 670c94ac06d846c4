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

Ranks per process (:func:`run_ranks`): where ``--num_processes P`` is
below a replica's M C ranks (``--model_parallel M``, ``--context_parallel
C``), each process starts R = M C / P ranks of its own, as processes of
torch.multiprocessing's spawn context joined over the same store (a
``file://`` store in a temporary directory when P = 1 and no
``--coordinator_address`` is given): rank ``process_id R + j`` runs on
``cuda:(rank % device_count)`` as a rank started alone would. Processes,
not threads: the CUDA libraries set each kernel's shared-memory attribute
once a process (a ``static bool`` beside each launch), so a second device
in one process would launch without it. The parent exits with the first
non-zero exit code of its ranks.
"""

from __future__ import annotations

import copy
import datetime
import logging
import os
import tempfile
import time
from typing import Any, Callable, Tuple

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


def replica_ranks(args) -> int:
    """M C: the ranks of one replica (``--model_parallel M``,
    ``--context_parallel C``)."""
    return max(getattr(args, "model_parallel", 1), 1) * max(getattr(args, "context_parallel", 1), 1)


def ranks_per_process(args) -> int:
    """R: the ranks each process starts. With ``--num_processes P`` below a
    replica's M C ranks, R = M C / P (P must divide M C; the world is M C
    ranks, one replica, D = 1); otherwise 1 (one rank a process, D = P / (M
    C))."""
    per_replica = replica_ranks(args)
    processes = max(getattr(args, "num_processes", 0) or 0, 1)
    if processes >= per_replica:
        return 1
    if per_replica % processes:
        raise ValueError(f"--num_processes {processes} does not divide the replica's "
                         f"{per_replica} ranks (--model_parallel x --context_parallel): each "
                         "process starts an equal share of them")
    return per_replica // processes


def data_size(args) -> int:
    """D: the data axis of the run the flags describe."""
    processes = max(getattr(args, "num_processes", 0) or 0, 1)
    return processes * ranks_per_process(args) // replica_ranks(args)


def run_ranks(args, fn: Callable[[Any], Any]) -> Any:
    """``fn(args)`` as this process's ranks: called here when each process
    is one rank (:func:`ranks_per_process` 1); otherwise R ranks started as
    spawned processes, rank j with ``--num_processes`` the world (P R),
    ``--process_id`` ``process_id R + j`` and the coordinator (a ``file://``
    store in a temporary directory when P = 1 and none is given). ``fn``
    must be a module-level function; it returns what the first of them
    returns (pickled through a file), and raises SystemExit with the first
    non-zero exit code of a rank, the others then terminated."""
    R = ranks_per_process(args)
    if R == 1:
        return fn(args)
    processes = max(args.num_processes or 0, 1)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="stlt_ranks_") as tmp:
        coordinator = args.coordinator_address
        if coordinator is None:
            if processes > 1:
                raise ValueError("ranks started by several processes join at "
                                 "--coordinator_address host:port")
            coordinator = f"file://{os.path.join(tmp, 'store')}"
        procs = []
        for j in range(R):
            child = copy.copy(args)
            child.num_processes, child.process_id = processes * R, args.process_id * R + j
            child.coordinator_address = coordinator
            result = os.path.join(tmp, "result.pt") if j == 0 else None
            procs.append(ctx.Process(target=_rank_main, args=(fn, child, result)))
        for p in procs:
            p.start()
        code = _wait_ranks(procs)
        if code:
            raise SystemExit(code)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def _rank_main(fn, args, result) -> None:
    """One spawned rank: ``fn(args)``, whose value the first rank writes to
    ``result``. It keeps the threads a rank started alone would have, so
    that it computes that rank's bits."""
    value = fn(args)
    if result is not None:
        torch.save(value, result)


def _wait_ranks(procs) -> int:
    """Wait for every rank; at the first non-zero exit code, terminate the
    others and return it (a signal's as 128 + its number), else 0."""
    while True:
        codes = [p.exitcode for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join()
            code = failed[0]
            return code if code > 0 else 128 - code
        if all(c == 0 for c in codes):
            return 0
        time.sleep(0.05)


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
