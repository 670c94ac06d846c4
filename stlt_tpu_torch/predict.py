"""Prediction CLI of the port: the serving surface.

Port of ``stlt_tpu/predict.py``: batch inference over a dataset JSON,
writing per-clip top-k predictions as JSON lines (``video_id``, ``top_k``
with ``label_id``, ``label`` and ``score``). It runs on the GPU unless
``--platform cpu`` is given; without a GPU it raises and never falls back to
the CPU. Checkpoints are reference-format ``.pt`` state_dicts.

    python -m stlt_tpu_torch.predict --dataset_name something --dataset_type layout \
        --model_name stlt --test_dataset_path val.json --labels_path labels.json \
        --videoid2size_path sizes.json --checkpoint_path best.pt \
        --compute_dtype bfloat16 --output predictions.jsonl --top_k 5
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from stlt_tpu_torch.configs import (
    DataConfig,
    category2id_for,
    make_model_config,
    position_table_rows,
)
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.models import models_factory
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


def predict(args):
    device = resolve_device(getattr(args, "platform", None))
    logging.basicConfig(level=logging.INFO)
    data_cfg = build_data_config(args, train=False, dataset_path=args.test_dataset_path)
    dataset = datasets_factory[args.dataset_type](data_cfg)
    loader = Loader(
        dataset,
        args.batch_size,
        collaters_factory[args.dataset_type](data_cfg),
        prefetch=max(args.num_workers, 2),
        workers=max(args.num_workers, 1),
    )
    id2label = {int(v): k for k, v in dataset.labels.items()}
    model_config = make_model_config(
        args.model_name,
        num_classes=len(dataset.labels),
        layout_num_frames=position_table_rows(data_cfg),
        unique_categories=len(category2id_for(args.dataset_name)),
        num_spatial_layers=args.num_spatial_layers,
        num_temporal_layers=args.num_temporal_layers,
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        remat=args.remat,
    )
    model = models_factory[args.model_name](model_config)
    load_checkpoint(args.checkpoint_path, model)
    model = model.to(device).eval()

    head = model.logit_names[-1]
    multilabel = args.dataset_name == "action_genome"
    rows = []
    index = 0
    with torch.inference_mode():
        for batch in to_device(loader, device):
            valid = batch.pop("valid")
            batch.pop("labels")
            logits = model(batch)[head].to(torch.float64).cpu().numpy()
            size = int(valid.sum())
            for row in range(size):
                scores = logits[row]
                if multilabel:
                    probs = 1.0 / (1.0 + np.exp(-scores))
                else:
                    exp = np.exp(scores - scores.max())
                    probs = exp / exp.sum()
                top = np.argsort(-probs)[: args.top_k]
                rows.append(
                    {
                        "video_id": dataset.json_file[index + row]["id"],
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
            index += size
    out_path = args.output or "predictions.jsonl"
    with open(out_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    logging.info("Wrote %d predictions to %s", len(rows), out_path)
    return rows


def main(argv=None):
    parser = build_parser("Per-clip top-k predictions with a trained model.")
    parser.add_argument("--top_k", type=int, default=5)
    parser.add_argument("--output", type=str, default="predictions.jsonl")
    return predict(parser.parse_args(argv))


if __name__ == "__main__":
    main()
