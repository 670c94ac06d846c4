"""Step checkpoints of ``train --resume_dir``: resume after an interruption.

Counterpart of the Orbax half of ``stlt_tpu/training/checkpoint.py``
(``make_checkpoint_manager`` :87, ``save_train_state`` :96,
``restore_train_state`` :108) with ``torch.save`` in place of Orbax: a step
checkpoint is one file ``step_<global step>.pt`` holding {model, optimizer,
scheduler, step, epoch}; the newest MAX_TO_KEEP (3, JAX's default) are
kept. Each write goes to a temporary file first and is renamed into place
(``os.replace``), so an interrupted write leaves the previous checkpoint
whole. JAX's Orbax directories are not read (``ROADMAP.md`` section C).

The best model itself is not a step checkpoint: ``train`` writes it with
``utils/convert.save_checkpoint`` (``.msgpack`` or ``.pt``).

Under a model mesh a step checkpoint still holds full tensors (the model's
and AdamW's moments, gathered by ``parallel/sharding.py``): saving gathers
on every rank (collective) and writes on one, restoring reads the full
file and cuts it to the rank's shards. Either file loads into one process.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from stlt_tpu_torch.parallel.mesh import active_model_mesh
from stlt_tpu_torch.parallel.sharding import (full_widths, gather_optimizer_state, optimizer_param_names,
                                              shard_optimizer_state, shard_state_dict)

MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.pt$")


def steps(directory: str) -> List[int]:
    """The global steps of the step checkpoints in ``directory``, oldest
    first (none when it does not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def path_of(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def save_train_state(directory: str, step: int, epoch: int, model, optimizer, scheduler, *,
                     write: bool = True) -> Optional[str]:
    """Write the step checkpoint of global step ``step`` after ``epoch``
    finished epochs, then delete all but the newest MAX_TO_KEEP. Returns
    its path. Under a model mesh every rank calls it (the gather of the
    full tensors is collective) and those with ``write`` False write
    nothing (and return None)."""
    mesh = active_model_mesh()
    with full_widths(model, mesh):
        model_state = model.state_dict()
    optimizer_state = optimizer.state_dict()
    if mesh is not None:
        optimizer_state = gather_optimizer_state(optimizer_state, optimizer_param_names(optimizer, model),
                                                 mesh)
    if not write:
        return None
    os.makedirs(directory, exist_ok=True)
    path = path_of(directory, step)
    tmp = f"{path}.tmp"
    torch.save({"model": model_state, "optimizer": optimizer_state,
                "scheduler": scheduler.state_dict(), "step": int(step), "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    for old in steps(directory)[:-MAX_TO_KEEP]:
        os.remove(path_of(directory, old))
    return path


def restore_train_state(directory: str, model, optimizer, scheduler) -> Optional[int]:
    """Load the newest step checkpoint of ``directory`` into the model,
    optimizer and scheduler and return its global step; None (and nothing
    loaded) when there is none. The file is read onto the CPU: the model's
    and AdamW's loads move each tensor to its parameter's device, and
    AdamW's step counts stay on the CPU, where a fresh run keeps them.
    Under a model mesh the full tensors are cut to this rank's shards
    first."""
    found = steps(directory)
    if not found:
        return None
    state = torch.load(path_of(directory, found[-1]), map_location="cpu", weights_only=True)
    mesh = active_model_mesh()
    if mesh is not None:
        state["model"] = shard_state_dict(state["model"], mesh)
        state["optimizer"] = shard_optimizer_state(state["optimizer"],
                                                   optimizer_param_names(optimizer, model), mesh)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])
