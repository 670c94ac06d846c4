#!/usr/bin/env python
"""Dump per-clip R3D appearance features to HDF5.

Own copy of ``tools/dump_features.py``: the frozen-BN R3D trunk
(``models/appearance.py::Resnet3D.forward_features``) runs over the HDF5
JPEG archive's clips (the appearance eval pipeline) and, per video id,
writes

- ``features``: ``[T', C]`` f32, the spatially pooled feature of each
  temporal unit (the per-frame analogue), and
- ``pooled``: ``[C]`` f32, their mean (the per-clip feature).

Resumable: ids already in the file are skipped, and a video's group appears
only once its datasets are written (``tools.write_video_group``).

    python -m stlt_tpu_torch.tools.dump_features --dataset_path D.json \\
        --labels_path L.json --videoid2size_path S.json --videos_path V.h5 \\
        --save_features_path F.h5 [--resnet_model_path r3d50_KMS_200ep.pth] \\
        [--platform cpu]

It runs on the card unless ``--platform cpu``, in bf16 as JAX's tool.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import torch

from stlt_tpu_torch.configs import AppearanceModelConfig
from stlt_tpu_torch.models.appearance import Resnet3D

COMPUTE_DTYPE = "bfloat16"  # the dump tools' trunk, as JAX's tools build it


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dumps R3D appearance features to HDF5.")
    p.add_argument("--dataset_path", type=str, required=True,
                   help="Layout/metadata JSON listing video ids.")
    p.add_argument("--labels_path", type=str, required=True)
    p.add_argument("--videoid2size_path", type=str, required=True)
    p.add_argument("--videos_path", type=str, required=True, help="HDF5 JPEG-frame archive.")
    p.add_argument("--resnet_model_path", type=str, default=None,
                   help="Kinetics R3D checkpoint (.pth); random init if omitted.")
    p.add_argument("--save_features_path", type=str, required=True)
    p.add_argument("--appearance_num_frames", type=int, default=32)
    p.add_argument("--spatial_size", type=int, default=112)
    p.add_argument("--resnet_depth", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--platform", type=str, default=None,
                   help="cpu, or the GPU (cuda) when unset.")
    return p


def build_extractor(resnet_depth: int, appearance_num_frames: int, compute_dtype: str,
                    resnet_model_path: Optional[str], device: torch.device) -> Resnet3D:
    """The R3D trunk in eval mode on ``device``: the Kinetics weights at
    ``resnet_model_path``, else the port's seeded init."""
    from stlt_tpu_torch.utils.convert import load_kinetics_r3d

    model = Resnet3D(AppearanceModelConfig(
        num_classes=1,  # the classifier is unused: features only
        appearance_num_frames=appearance_num_frames, resnet_model_path=resnet_model_path,
        resnet_depth=resnet_depth, compute_dtype=compute_dtype))
    if resnet_model_path:
        load_kinetics_r3d(model, resnet_model_path)
        logging.info("Loaded R3D weights from %s", resnet_model_path)
    return model.to(device).eval()


def clip_features(model: Resnet3D, video_frames: torch.Tensor) -> torch.Tensor:
    """``[B, T, S, S, 3]`` frames to ``[B, T', C]`` f32: each temporal
    unit's spatial mean, taken in the compute dtype as JAX's tool takes it."""
    with torch.inference_mode():
        feats = model.forward_features({"video_frames": video_frames})  # [B, C, T', H', W']
        return feats.mean(dim=(3, 4)).float().transpose(1, 2)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from stlt_tpu_torch.configs import DataConfig
    from stlt_tpu_torch.data.appearance import AppearanceDataset, collate_appearance
    from stlt_tpu_torch.data.loader import Loader
    from stlt_tpu_torch.predict import resolve_device
    from stlt_tpu_torch.tools import features_file, write_video_group

    device = resolve_device(args.platform)
    dataset = AppearanceDataset(DataConfig(
        dataset_name="something", dataset_path=args.dataset_path, labels_path=args.labels_path,
        videoid2size_path=args.videoid2size_path, videos_path=args.videos_path, train=False,
        appearance_num_frames=args.appearance_num_frames, spatial_size=args.spatial_size))
    model = build_extractor(args.resnet_depth, args.appearance_num_frames, COMPUTE_DTYPE,
                            args.resnet_model_path, device)
    video_ids = [clip["id"] for clip in dataset.json_file]
    loader = Loader(dataset, args.batch_size, collate_appearance, prefetch=2)
    written = 0
    with features_file(args.save_features_path) as (out, done):
        index = 0
        for batch in loader:
            size = int(batch["valid"].sum())
            frames = torch.from_numpy(batch["video_frames"]).to(device)
            feats = clip_features(model, frames).cpu().numpy()
            for row in range(size):
                video_id = video_ids[index + row]
                if video_id in done:
                    continue  # resumed: written by an earlier run
                write_video_group(out, video_id, {"features": feats[row],
                                                  "pooled": feats[row].mean(axis=0)})
                done.add(video_id)
                written += 1
            index += size
    logging.info("Wrote features for %d videos to %s", written, args.save_features_path)
    return written


if __name__ == "__main__":
    main()
