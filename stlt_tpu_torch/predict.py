"""Prediction CLI of the port: the serving surface.

Port of ``stlt_tpu/predict.py``: batch inference over a dataset JSON,
writing per-clip top-k predictions as JSON lines (``video_id``, ``top_k``
with ``label_id``, ``label`` and ``score``) from the model's last head
(``ensemble`` for CACNF). Every factory model serves: ``stlt`` on layout
data, ``resnet3d`` and ``resnet3d-transformer`` on ``--dataset_type
appearance``, ``lcf``, ``caf`` and ``cacnf`` on ``--dataset_type
multimodal`` (HDF5 JPEG frames, ``--videos_path``). It runs on the GPU
unless ``--platform cpu`` is given; without a GPU it raises and never falls
back to the CPU. Checkpoints are reference-format ``.pt`` state_dicts.

Every model serves over N processes with ``--num_processes N --process_id
r --coordinator_address host:port`` (``parallel/``, the data axis): each
rank loads and serves its rows [r B / N, (r + 1) B / N) of every global
batch (``--batch_size`` B, which N must divide), and the coordinator (rank
0) gathers the ranks' rows and writes the predictions in global order.
Every model also serves over a context ring of C processes with
``--context_parallel C --num_processes C``: every rank loads the same
batches (the layout frame axis padded to a multiple of C) and gets the same
logits; only the coordinator writes the predictions. STLT's backbone and
the fusion models' layout branch keep the rank's frames and run the
temporal attention as a ring (``ops/ring.py``); CAF and CACNF gather the
layout stream's frames over the ring and run the appearance branch, the
fusion blocks and the heads replicated on every rank (``models/fusion.py``);
``resnet3d`` and ``resnet3d-transformer``, with no frame axis, run whole on
every rank. Under a ring the R3D convolutions take fixed, deterministic
cuDNN algorithms (:func:`set_conv_algorithms`), so the ranks' forwards
give the same bits. Both axes at once, ``--num_processes D C --context_parallel C``,
serve on a grid of D rings of C ranks: ring d loads the rows [d B / D,
(d + 1) B / D) and its ranks their frames of them, and the rows are
gathered over the data group (the ranks of one context index).

    python -m stlt_tpu_torch.predict --dataset_name something --dataset_type multimodal \
        --model_name cacnf --test_dataset_path val.json --labels_path labels.json \
        --videoid2size_path sizes.json --videos_path videos.h5 --checkpoint_path best.pt \
        --compute_dtype bfloat16 --output predictions.jsonl --top_k 5
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch
import torch.distributed as dist

from stlt_tpu_torch.configs import (
    DataConfig,
    category2id_for,
    make_model_config,
    position_table_rows,
)
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import VALID_TOTAL, Loader, to_device
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parallel import distributed
from stlt_tpu_torch.parallel.mesh import (active_context_mesh, active_data_mesh, check_batch, make_mesh,
                                          set_active_mesh)
from stlt_tpu_torch.parser import build_parser
from stlt_tpu_torch.utils.convert import load_checkpoint


def resolve_device(platform) -> torch.device:
    """``--platform``: ``cpu`` runs on the CPU; unset, ``cuda`` or ``gpu``
    needs a CUDA device and raises without one."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown --platform {platform!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass --platform cpu to run on the CPU"
        )
    return torch.device("cuda")


def build_data_config(args, *, train: bool, dataset_path: str) -> DataConfig:
    """Own copy of ``stlt_tpu/train.py::build_data_config``."""
    return DataConfig(
        dataset_name=args.dataset_name,
        dataset_path=dataset_path,
        labels_path=args.labels_path,
        videoid2size_path=args.videoid2size_path,
        videos_path=args.videos_path,
        train=train,
        layout_num_frames=args.layout_num_frames,
        appearance_num_frames=args.appearance_num_frames,
        score_threshold=args.score_threshold,
        spatial_size=args.spatial_size,
        frames_multiple=getattr(args, "context_parallel", 1),
        fast_decode=args.fast_decode,
        native_decode=getattr(args, "native_decode", False),
        device_normalize=getattr(args, "device_normalize", False),
    )


def check_flags(args) -> None:
    """The serving CLIs' flags: an unknown model or dataset type raises with
    the choices; flags of later slices raise with the ``ROADMAP.md`` item
    they wait for. Two parallel axes run for every model, one process a
    rank: the data axis (``--num_processes N``, N dividing
    ``--batch_size``) and the context axis (``--context_parallel C`` with
    ``--num_processes D C``: D rings of C ranks, D dividing
    ``--batch_size``)."""
    for flag, value, choices in (("--model_name", args.model_name, models_factory),
                                 ("--dataset_type", args.dataset_type, datasets_factory)):
        if value not in choices:
            raise ValueError(f"{flag} {value!r} is not one of {sorted(choices)}")
    context, processes = args.context_parallel, max(args.num_processes, 1)
    later = [
        (args.model_parallel > 1, "--model_parallel > 1", "A9 (model axis)"),
        (processes < context, f"--context_parallel {context} over {processes} process(es) (the "
         "port runs one rank a process)", "A9 (ranks per process)"),
        (getattr(args, "native_decode", False), "--native_decode", "A10"),
    ]
    for hit, flag, item in later:
        if hit:
            raise NotImplementedError(f"{flag} is not ported yet: it waits for ROADMAP.md item {item}")
    if processes % context:
        raise ValueError(f"--context_parallel {context} does not divide --num_processes {processes}")
    if processes == 1 and args.coordinator_address is not None:
        raise ValueError("--coordinator_address joins the ranks of a multi-process run: pass "
                         "--num_processes N > 1 with it")
    check_batch(processes // context, args.batch_size)


def build_model_config(args, dataset, data_cfg: DataConfig, **capacities):
    """The model config of ``--model_name`` from the flags and the dataset,
    as ``stlt_tpu/predict.py:54-70`` and ``stlt_tpu/train.py:217-240``
    build it (the backbone flags act in training only); ``capacities`` are
    the ragged levers' (``inference --live_prefix``)."""
    return make_model_config(
        args.model_name,
        num_classes=len(dataset.labels),
        layout_num_frames=position_table_rows(data_cfg),
        unique_categories=len(category2id_for(args.dataset_name)),
        num_spatial_layers=args.num_spatial_layers,
        num_temporal_layers=args.num_temporal_layers,
        appearance_num_frames=args.appearance_num_frames,
        resnet_model_path=args.resnet_model_path,
        load_backbone_path=args.load_backbone_path,
        freeze_backbone=args.freeze_backbone,
        hidden_size=args.hidden_size,
        hidden_dropout_prob=args.hidden_dropout_prob,
        num_attention_heads=args.num_attention_heads,
        num_appearance_layers=args.num_appearance_layers,
        num_fusion_layers=args.num_fusion_layers,
        resnet_depth=args.resnet_depth,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        remat=args.remat,
        **capacities,
    )


def clip_ids(dataset):
    """The clip ids in dataset order (the loader keeps it when not
    shuffling); a multimodal dataset's come from its layout dataset."""
    json_file = getattr(dataset, "json_file", None)
    if json_file is None:
        json_file = dataset.layout_dataset.json_file
    return [clip["id"] for clip in json_file]


def set_conv_algorithms(device: torch.device) -> None:
    """On the card, how cuDNN picks the R3D convolutions' algorithms, and
    f32 convolutions stay f32 (no TF32). Alone or on a data axis it times
    them for the appearance branch's shapes (``cudnn.benchmark``). On a
    context ring every rank runs the appearance branch replicated on the
    same clips: there the algorithms are fixed and deterministic, so every
    rank computes the same forward (two processes timing them on one card
    can pick different ones, other sums, other bits) and no weight gradient
    sums in an order of its own."""
    if device.type != "cuda":
        return
    ring = active_context_mesh() is not None
    torch.backends.cudnn.benchmark = not ring
    torch.backends.cudnn.deterministic = ring
    torch.backends.cudnn.allow_tf32 = False


def load_served_model(args, model_config, device: torch.device):
    """The factory model with the checkpoint loaded, on ``device`` in eval
    mode, the convolutions' algorithms set (:func:`set_conv_algorithms`)."""
    set_conv_algorithms(device)
    model = models_factory[args.model_name](model_config)
    load_checkpoint(args.checkpoint_path, model)
    return model.to(device).eval()


def start_processes(args) -> torch.device:
    """This process's device and, under ``--num_processes``, its rank of
    the process group and the active mesh (``parallel/``: a data or a
    context axis)."""
    logging.basicConfig(level=logging.INFO)
    platform = getattr(args, "platform", None)
    if not distributed.maybe_initialize(args):
        return resolve_device(platform)
    device = distributed.process_device(platform, args.process_id)
    set_active_mesh(make_mesh(args.model_parallel, args.context_parallel, device,
                              batch_size=args.batch_size))
    return device


def loader_rows(batch_size: int):
    """This rank's rows of every global batch under a data axis (the
    loaders' ``rows``), else None (the whole batch)."""
    mesh = active_data_mesh()
    return None if mesh is None else distributed.process_row_span(mesh, batch_size)


def stop_processes() -> None:
    set_active_mesh(None)
    distributed.shutdown()


def predict(args):
    check_flags(args)
    device = start_processes(args)
    try:
        return serve(args, device)
    finally:
        stop_processes()


def serve(args, device):
    """The predictions of ``args``' dataset on ``device`` (this rank's, under
    ``--num_processes``); the coordinator writes them to ``--output``."""
    data_cfg = build_data_config(args, train=False, dataset_path=args.test_dataset_path)
    dataset = datasets_factory[args.dataset_type](data_cfg)
    span = loader_rows(args.batch_size)
    loader = Loader(
        dataset,
        args.batch_size,
        collaters_factory[args.dataset_type](data_cfg),
        prefetch=max(args.num_workers, 2),
        workers=max(args.num_workers, 1),
        rows=span,
    )
    id2label = {int(v): k for k, v in dataset.labels.items()}
    ids = clip_ids(dataset)
    model = load_served_model(args, build_model_config(args, dataset, data_cfg), device)

    head = model.logit_names[-1]
    multilabel = args.dataset_name == "action_genome"
    first = 0 if span is None else span[0]  # this rank's first row of each global batch
    rows = []
    with torch.inference_mode():
        for b, batch in enumerate(to_device(loader, device)):
            valid = batch.pop("valid")
            batch.pop("labels")
            batch.pop(VALID_TOTAL, None)
            logits = model(batch)[head].to(torch.float64).cpu().numpy()
            index = b * args.batch_size + first
            for row in range(int(valid.sum())):
                scores = logits[row]
                if multilabel:
                    probs = 1.0 / (1.0 + np.exp(-scores))
                else:
                    exp = np.exp(scores - scores.max())
                    probs = exp / exp.sum()
                top = np.argsort(-probs)[: args.top_k]
                rows.append(
                    {
                        "index": index + row,
                        "video_id": ids[index + row],
                        "top_k": [
                            {
                                "label_id": int(c),
                                "label": id2label.get(int(c), str(int(c))),
                                "score": float(probs[c]),
                            }
                            for c in top
                        ],
                    }
                )
    if span is not None:
        rows = gather_rows(rows)
    for row in rows:
        del row["index"]
    if distributed.is_coordinator():
        out_path = args.output or "predictions.jsonl"
        with open(out_path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        logging.info("Wrote %d predictions to %s", len(rows), out_path)
    return rows


def gather_rows(rows):
    """Every data rank's prediction rows (each with its global ``index``),
    on every rank, in global order: one ``all_gather_object`` over the data
    group (a grid's rings hold their rows once each)."""
    group = active_data_mesh().data_group
    gathered = [None] * dist.get_world_size(group)
    dist.all_gather_object(gathered, rows, group=group)
    return sorted((row for part in gathered for row in part), key=lambda row: row["index"])


def main(argv=None):
    parser = build_parser("Per-clip top-k predictions with a trained model.")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output", type=str, default="predictions.jsonl")
    return predict(parser.parse_args(argv))


if __name__ == "__main__":
    main()
