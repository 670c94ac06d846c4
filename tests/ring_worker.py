"""One rank of a context-parallel run of the port on the CPU, for
``tests/test_torch_ring.py``. Imports torch, numpy and the port only.

    python tests/ring_worker.py TASK WORKDIR RANK WORLD

Tasks (inputs and outputs under WORKDIR):

- ``op``: ``ring_attention`` on this rank's frames of ``inputs.npz`` (q, k,
  v [B, T, N, D], lengths [B], bias [B, 1, T, T], keep [B, N, T, T], seed,
  rate) in the lengths mode (causal), the dense mode, the seed mode
  (lengths, causal, dropout) and the mask mode (dense, dropout); writes
  ``op_RANK.npz``;
- ``stlt``: a port STLT (``config.json``, ``state.pt``) on the batch of
  ``batch.npz`` under a context mesh; writes the logits to ``stlt_RANK.npy``;
- ``predict``: ``stlt_tpu_torch.predict.main`` with the argv of
  ``argv.json`` plus this rank's ``--process_id`` and a ``file://``
  coordinator under WORKDIR.

The process group starts from a ``file://`` store in WORKDIR, so parallel
test workers never share a port.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stlt_tpu_torch.parallel.mesh import make_mesh, set_active_mesh  # noqa: E402


def _group(workdir, task, rank, world):
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, task + '.store')}",
                            world_size=world, rank=rank)
    return make_mesh(1, world)


def op(workdir, rank, world):
    from stlt_tpu_torch.ops.ring import ring_attention

    mesh = _group(workdir, "op", rank, world)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    T = data["q"].shape[1]
    t = T // world
    rows = slice(rank * t, (rank + 1) * t)
    q, k, v = (torch.from_numpy(data[name][:, rows]) for name in ("q", "k", "v"))
    lengths = torch.from_numpy(data["lengths"])
    out = {
        "lengths": ring_attention(q, k, v, None, mesh, kv_lengths=lengths, causal=True),
        "dense": ring_attention(q, k, v, torch.from_numpy(data["bias"][:, :, rows]), mesh),
        "seed": ring_attention(q, k, v, None, mesh, kv_lengths=lengths, causal=True,
                               dropout_seed=int(data["seed"]), dropout_rate=float(data["rate"])),
        "mask": ring_attention(q, k, v, torch.from_numpy(data["bias"][:, :, rows]), mesh,
                               dropout_mask=torch.from_numpy(data["keep"][:, :, rows]),
                               dropout_rate=float(data["rate"])),
    }
    np.savez(os.path.join(workdir, f"op_{rank}.npz"), **{k: v.numpy() for k, v in out.items()})
    dist.destroy_process_group()


def stlt(workdir, rank, world):
    from stlt_tpu_torch.configs import StltModelConfig
    from stlt_tpu_torch.models import models_factory

    set_active_mesh(_group(workdir, "stlt", rank, world))
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = StltModelConfig(**json.load(f))
    model = models_factory["stlt"](cfg).eval()
    model.load_state_dict(torch.load(os.path.join(workdir, "state.pt")), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batch.npz")).items()}
    with torch.inference_mode():
        logits = model(batch)["stlt"]
    np.save(os.path.join(workdir, f"stlt_{rank}.npy"), logits.numpy())
    set_active_mesh(None)
    dist.destroy_process_group()


def predict(workdir, rank, world):
    from stlt_tpu_torch import predict as port_predict

    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    port_predict.main(argv + ["--process_id", str(rank), "--coordinator_address",
                              f"file://{os.path.join(workdir, 'predict.store')}"])


if __name__ == "__main__":
    task, workdir, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    {"op": op, "stlt": stlt, "predict": predict}[task](workdir, rank, world)
