"""One rank of a context-parallel run of the port on the CPU, for
``tests/test_torch_ring.py`` and ``tests/test_torch_ring_train*.py``. Imports torch, numpy and the port only.

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
  coordinator under WORKDIR;
- ``inference``: ``stlt_tpu_torch.inference.main`` likewise; writes the
  metrics this rank returns to ``inference_RANK.json``;
- ``predict_models``: under one process group, ``predict.serve`` for each
  argv of ``models.json`` (each with its own ``--output``);
- ``op_grad``: the gradients of ``ring_attention`` on this rank's frames of
  ``inputs.npz`` (as ``op``, plus the cotangent g [B, T, N, D]) for the
  cotangent's rows of this rank, in the lengths mode (causal), the dense
  mode, the seed mode and the mask mode (this rank's rows of ``keep``, in
  the dense mode and in the lengths mode); writes ``op_grad_RANK.npz``;
- ``train``: ``steps`` train steps (``training.loop.make_train_step``, the
  hyperparameters of ``hp.json``) of a port STLT (``config.json``,
  ``state.pt``) on the batch of ``batch.npz`` under a context mesh; writes
  ``train_RANK.npz``: the losses, the parameters after every step (one flat
  f32 vector each), the first step's gradients as the clip sees them (after
  the sum over the ring) and ``probe``: the frames embeddings of this
  rank's frames in train mode (the embedding dropouts and the spatial
  encoder's dropout sites at the global coordinates) from a generator
  seeded ``probe_seed``, before the first step (with dropout; else empty);
- ``train_cli``: ``stlt_tpu_torch.train.main`` with the argv of
  ``argv.json`` plus this rank's ``--process_id``, a ``file://``
  coordinator, ``--save_model_path best_RANK.pt`` (unless the argv names
  one; ``{rank}`` in the argv is replaced by the rank) and ``--log_filepath
  log_RANK.txt`` under WORKDIR;
- ``data_train``: as ``train``, under a DATA mesh of WORLD ranks: this
  rank's contiguous rows of ``batch.npz`` (with the global batch's count of
  valid rows, ``loader.VALID_TOTAL``), every gradient and the loss summed
  over the ranks; writes ``data_train_RANK.npz``;
- ``grid_train``: as ``train``, on a grid of WORLD / 2 rings of 2 ranks
  (``make_mesh(1, 2)``): the rows of this rank's data index, its frames of
  them, the backbone's gradients summed over its ring and then every
  gradient and the loss over its data group; writes ``grid_train_RANK.npz``;
- ``grid_op``: ``ring_attention`` in the seed mode (lengths, causal,
  dropout) on the grid, forward and gradients, on this rank's rows and
  frames of ``inputs.npz`` (as ``op_grad``); writes ``grid_op_RANK.npz``;
- ``fusion``: every case of ``fusion.json`` (:func:`run_fusion_case`: a
  factory model's eval logits, one train step's loss and gradients, or
  AdamW steps) under one process group of WORLD ranks, a ring of 2 or a
  grid of WORLD / 2 rings (``make_mesh(1, 2)``), each rank on its data
  index's rows; writes ``CASE_RANK.npz`` for each case.

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


def predict_models(workdir, rank, world):
    from stlt_tpu_torch import predict as port_predict
    from stlt_tpu_torch.parser import build_parser

    with open(os.path.join(workdir, "models.json")) as f:
        runs = json.load(f)
    parser = build_parser("ring worker")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output", type=str)
    process = ["--num_processes", str(world), "--process_id", str(rank), "--coordinator_address",
               f"file://{os.path.join(workdir, 'predict_models.store')}"]
    device = port_predict.start_processes(parser.parse_args(runs[0] + process))
    try:
        for argv in runs:
            args = parser.parse_args(argv + process)
            port_predict.check_flags(args)
            port_predict.serve(args, device)
    finally:
        port_predict.stop_processes()


def inference(workdir, rank, world):
    from stlt_tpu_torch import inference as port_inference

    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    metrics = port_inference.main(argv + ["--process_id", str(rank), "--coordinator_address",
                                          f"file://{os.path.join(workdir, 'inference.store')}"])
    with open(os.path.join(workdir, f"inference_{rank}.json"), "w") as f:
        json.dump({k: float(v) for k, v in metrics.items()}, f)


def op_grad(workdir, rank, world):
    from stlt_tpu_torch.ops.ring import ring_attention

    mesh = _group(workdir, "op_grad", rank, world)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    T = data["q"].shape[1]
    t = T // world
    rows = slice(rank * t, (rank + 1) * t)
    lengths = torch.from_numpy(data["lengths"])
    modes = {
        "lengths": dict(bias=None, kv_lengths=lengths, causal=True),
        "dense": dict(bias=torch.from_numpy(data["bias"][:, :, rows])),
        "seed": dict(bias=None, kv_lengths=lengths, causal=True, dropout_seed=int(data["seed"]),
                     dropout_rate=float(data["rate"])),
    }
    keep = torch.from_numpy(data["keep"][:, :, rows].copy())
    modes["mask"] = dict(bias=torch.from_numpy(data["bias"][:, :, rows]), dropout_mask=keep,
                         dropout_rate=float(data["rate"]))
    modes["mask_lengths"] = dict(bias=None, kv_lengths=lengths, causal=True, dropout_mask=keep,
                                 dropout_rate=float(data["rate"]))
    out = {}
    for mode, kw in modes.items():
        leaves = [torch.from_numpy(data[name][:, rows].copy()).requires_grad_() for name in "qkv"]
        bias = kw.pop("bias")
        ring_attention(*leaves, bias, mesh, **kw).backward(torch.from_numpy(data["g"][:, rows].copy()))
        for name, leaf in zip(("dq", "dk", "dv"), leaves):
            out[f"{mode}_{name}"] = leaf.grad.numpy()
    np.savez(os.path.join(workdir, f"op_grad_{rank}.npz"), **out)
    dist.destroy_process_group()


def grid_op(workdir, rank, world):
    from stlt_tpu_torch.ops.ring import ring_attention

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'grid_op.store')}",
                            world_size=world, rank=rank)
    mesh = make_mesh(1, 2)
    data = np.load(os.path.join(workdir, "inputs.npz"))
    B, T = data["q"].shape[:2]
    b, t = B // mesh.data_size, T // 2
    rows, frames = slice(mesh.data_index * b, (mesh.data_index + 1) * b), \
        slice(mesh.context_index * t, (mesh.context_index + 1) * t)
    leaves = [torch.from_numpy(data[name][rows, frames].copy()).requires_grad_() for name in "qkv"]
    out = ring_attention(*leaves, None, mesh, kv_lengths=torch.from_numpy(data["lengths"][rows]),
                         causal=True, dropout_seed=int(data["seed"]), dropout_rate=float(data["rate"]))
    out.backward(torch.from_numpy(data["g"][rows, frames].copy()))
    np.savez(os.path.join(workdir, f"grid_op_{rank}.npz"), out=out.detach().numpy(),
             **{name: leaf.grad.numpy() for name, leaf in zip(("dq", "dk", "dv"), leaves)})
    dist.destroy_process_group()


def train(workdir, rank, world):
    _train(workdir, rank, world, "train")


def grid_train(workdir, rank, world):
    _train(workdir, rank, world, "grid_train")


def data_train(workdir, rank, world):
    _train(workdir, rank, world, "data_train")


def _train(workdir, rank, world, task):
    from stlt_tpu_torch.configs import StltModelConfig
    from stlt_tpu_torch.data.loader import VALID_TOTAL
    from stlt_tpu_torch.models import models_factory
    from stlt_tpu_torch.training import loop
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.optimizer import make_optimizer

    if task == "train":
        mesh = _group(workdir, task, rank, world)
    else:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, task + '.store')}",
                                world_size=world, rank=rank)
        mesh = make_mesh(1, 2 if task == "grid_train" else 1)
    set_active_mesh(mesh)
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = StltModelConfig(**json.load(f))
    with open(os.path.join(workdir, "hp.json")) as f:
        hp = json.load(f)
    model = models_factory["stlt"](cfg)
    model.load_state_dict(torch.load(os.path.join(workdir, "state.pt")), strict=True)
    optimizer, scheduler = make_optimizer(model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
                                          num_warmup_steps=hp["warmup"], num_training_steps=hp["total"])
    first = {}
    clip = loop.clip_by_global_norm_

    def clip_spy(params, clip_val):  # the gradients as the clip sees them, at the first step
        if not first:
            first.update({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        return clip(params, clip_val)

    loop.clip_by_global_norm_ = clip_spy
    step = loop.make_train_step(model, optimizer, scheduler, make_criterion("something"), hp["clip_val"])
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batch.npz")).items()}
    if mesh.data_size > 1:
        rows = batch["labels"].shape[0] // mesh.data_size
        d = mesh.data_index
        batch = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()} | {
            VALID_TOTAL: batch["valid"].sum()}
    probe = _probe(model, batch, hp["probe_seed"], mesh) if cfg.hidden_dropout_prob > 0 else np.zeros(0)
    out = {"losses": [], "probe": probe}
    for i in range(hp["steps"]):
        loss, _ = step(batch, loop.step_generator(0, i))
        out["losses"].append(float(loss))
        out[f"params_{i}"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
    out.update({f"grad_{n}": g.numpy() for n, g in first.items()})
    out.update({f"final_{n}": v.numpy() for n, v in model.state_dict().items()})
    np.savez(os.path.join(workdir, f"{task}_{rank}.npz"), **out)
    set_active_mesh(None)
    dist.destroy_process_group()


def _probe(model, batch, seed, mesh):
    """This rank's frames embeddings in train mode (see ``train``)."""
    from stlt_tpu_torch.training.loop import shard_frames

    local, offset = shard_frames(batch, mesh.context_size, mesh.context_index)
    model.train()
    with torch.no_grad():
        emb = model.backbone.frames_embeddings(local, torch.Generator().manual_seed(seed),
                                               position_offset=offset,
                                               total_frames=batch["frame_types"].shape[1])
    return emb.numpy()


def train_cli(workdir, rank, world):
    from stlt_tpu_torch import train as port_train

    with open(os.path.join(workdir, "argv.json")) as f:
        argv = [a.replace("{rank}", str(rank)) for a in json.load(f)]
    if "--save_model_path" not in argv:
        argv += ["--save_model_path", os.path.join(workdir, f"best_{rank}.pt")]
    port_train.main(argv + ["--process_id", str(rank), "--coordinator_address",
                            f"file://{os.path.join(workdir, 'train_cli.store')}",
                            "--log_filepath", os.path.join(workdir, f"log_{rank}.txt")])


def run_fusion_case(workdir, case, mesh=None):
    """One case of ``fusion.json`` on this rank (``mesh``: the active mesh,
    None in one process): the factory model ``case["model"]`` built from
    ``case["config"]`` (its config class's fields), ``case["state"]``
    loaded, the appearance encoder's dropout set to
    ``case["encoder_dropout"]`` while it is built and, with
    ``quiet_ring_attention``, the layout branch's temporal attention
    dropout off (the one site on the ring, whose bits are the ring's own:
    ``ops/ring.py``); the batch ``case["batch"]`` (``.npz``), this rank's
    data rows of it under a data axis. Kinds:

    - ``eval``: the logits of every head in eval mode;
    - ``step``: ``training.loop.loss_and_grads`` at (seed 0, step 0), the
      FrozenBatchNorm parameters frozen as ``make_optimizer`` freezes them:
      the loss, every gradient as the clip would see it, and the logits of
      a train-mode forward drawing from the same generator;
    - ``train``: ``case["steps"]`` AdamW steps (``make_train_step``,
      ``case["hp"]``, ``freeze_backbone`` as the config says): the losses
      and every parameter after each step;
    - ``sync``: (under a ring) every parameter's gradient set to (rank + 1)
      (i + 1) for the i-th parameter, then ``training.loop.sync_over_ring_``:
      the gradients it leaves.

    Returns the arrays (``logits_HEAD``, ``loss``, ``grad_NAME``,
    ``losses``, ``params_I``)."""
    from stlt_tpu_torch.configs import make_model_config
    from stlt_tpu_torch.data.loader import VALID_TOTAL
    from stlt_tpu_torch.models import appearance, models_factory
    from stlt_tpu_torch.models.stlt import StltBackbone, backbone_frozen
    from stlt_tpu_torch.training import loop
    from stlt_tpu_torch.training.criterion import make_criterion
    from stlt_tpu_torch.training.optimizer import frozen_stats_mask, make_optimizer

    name = case["model"]
    cfg = make_model_config(name, **case["config"])
    saved = appearance.TORCH_ENCODER_DROPOUT
    appearance.TORCH_ENCODER_DROPOUT = case.get("encoder_dropout", saved)
    try:
        model = models_factory[name](cfg)
    finally:
        appearance.TORCH_ENCODER_DROPOUT = saved
    model.load_state_dict(torch.load(os.path.join(workdir, case["state"])), strict=True)
    if case.get("quiet_ring_attention"):
        for module in model.modules():
            if isinstance(module, StltBackbone):
                for layer in module.transformer.layers:
                    layer.self_attn.dropout_rate = 0.0
    batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, case["batch"])).items()}
    if mesh is not None and mesh.data_size > 1:
        rows = batch["labels"].shape[0] // mesh.data_size
        d = mesh.data_index
        batch = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()} | {
            VALID_TOTAL: batch["valid"].sum()}
    inputs = {k: v for k, v in batch.items() if k not in ("labels", "valid", VALID_TOTAL)}
    criterion = make_criterion("something")
    out = {}
    if case["kind"] == "eval":
        with torch.inference_mode():
            logits = model.eval()(inputs)
        out.update({f"logits_{head}": v.numpy() for head, v in logits.items()})
    elif case["kind"] == "step":
        trainable = frozen_stats_mask(model)
        for n, p in model.named_parameters():
            p.requires_grad_(trainable[n])
        loss = loop.loss_and_grads(model, criterion, batch, loop.step_generator(0, 0))
        out["loss"] = loss.numpy()
        out.update({f"grad_{n}": p.grad.numpy() for n, p in model.named_parameters()
                    if p.grad is not None})
        with torch.no_grad():
            logits = model.train()(inputs, loop.step_generator(0, 0))
        out.update({f"logits_{head}": v.numpy() for head, v in logits.items()})
    elif case["kind"] == "sync":
        rank = 0 if mesh is None else mesh.rank
        for i, p in enumerate(model.parameters()):
            p.grad = torch.full_like(p, float((rank + 1) * (i + 1)))
        loop.sync_over_ring_(model, mesh)
        out.update({f"grad_{n}": p.grad.numpy() for n, p in model.named_parameters()})
    else:
        hp = case["hp"]
        optimizer, scheduler = make_optimizer(
            model, learning_rate=hp["lr"], weight_decay=hp["weight_decay"],
            num_warmup_steps=hp["warmup"], num_training_steps=hp["total"],
            freeze_backbone=backbone_frozen(cfg))
        step = loop.make_train_step(model, optimizer, scheduler, criterion, hp["clip_val"])
        losses = []
        for i in range(case["steps"]):
            losses.append(float(step(batch, loop.step_generator(0, i))[0]))
            out[f"params_{i}"] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
        out["losses"] = np.array(losses)
    return out


def fusion(workdir, rank, world):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the cores
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'fusion.store')}",
                            world_size=world, rank=rank)
    mesh = make_mesh(1, 2)
    set_active_mesh(mesh)
    with open(os.path.join(workdir, "fusion.json")) as f:
        cases = json.load(f)
    for label, case in cases.items():
        np.savez(os.path.join(workdir, f"{label}_{rank}.npz"), **run_fusion_case(workdir, case, mesh))
    set_active_mesh(None)
    dist.destroy_process_group()


if __name__ == "__main__":
    task, workdir, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    {"op": op, "stlt": stlt, "predict": predict, "op_grad": op_grad, "train": train,
     "train_cli": train_cli, "data_train": data_train, "inference": inference,
     "predict_models": predict_models, "grid_train": grid_train, "grid_op": grid_op,
     "fusion": fusion}[task](
        workdir, rank, world)
