#!/usr/bin/env python
"""Dump per-frame and per-box ROI features to HDF5.

Own copy of ``tools/dump_perbox_features.py``, with its output schema (the
reference's, ``dump_perbox_features.py:92-105``): one HDF5 group per video
id holding

- ``{i}-frame``: the whole-frame ROI feature of frame ``i``, and
- ``{i}-frame-{k}-box``: the feature of that frame's ``k``-th box,

each a flat f32 vector from the reference's pooling chain: ROI-Align ``7 x
7``, ``sampling_ratio=2``, then adaptive average pooling to ``3 x 3``,
flattened channels-last as JAX's tool flattens it (``ops/roi_align.py``).

As in JAX's tool, the frozen-BN R3D trunk (``--resnet_model_path``, the
Kinetics checkpoint the appearance models load) stands in for
torchvision's Faster-R-CNN FPN, which cannot be fetched offline: each
frame's boxes pool on the temporally nearest R3D feature map, and a feature
has ``9 C`` values. Frames go through the appearance eval transform
(shorter side resized, centre crop); boxes follow by per-axis scaling and
the crop's offset. Boxes pad to the dataset's most in a frame and frames to
``--window``; the padding is dropped on write.

Resumable: ids already in the file are skipped, and a video's group appears
only once its datasets are written (``tools.write_video_group``).

    python -m stlt_tpu_torch.tools.dump_perbox_features --videos_path V.h5 \\
        --dataset_path D.json --save_features_path F.h5 [--platform cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import re
from typing import List, Optional

import numpy as np
import torch

from stlt_tpu_torch.models.appearance import Resnet3D
from stlt_tpu_torch.ops.roi_align import adaptive_avg_pool2d, roi_align


def natural_sorted(keys: List[str]) -> List[str]:
    """``natsorted``'s order (reference dump_perbox_features.py:70): digit
    runs compare as numbers, text runs as text."""
    def split(key):
        # (0, number) / (1, text) pairs: numbers sort before text at the same
        # position, and an int never meets a str.
        return tuple((0, int(p)) if p.isdigit() else (1, p) for p in re.split(r"(\d+)", key) if p)

    return sorted(keys, key=split)


def transform_boxes(boxes, orig_hw, new_hw, crop_top_left) -> np.ndarray:
    """Original-image boxes in the crop's coordinates: per-axis ratios as
    torchvision's ``resize_boxes``, then the centre crop's offset; not
    clamped (ROI-Align zero-fills samples off the map)."""
    (h0, w0), (h1, w1) = orig_hw, new_hw
    top, left = crop_top_left
    out = np.asarray(boxes, np.float32).copy()
    out[:, [0, 2]] = out[:, [0, 2]] * (w1 / w0) - left
    out[:, [1, 3]] = out[:, [1, 3]] * (h1 / h0) - top
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dumps per-frame and per-bounding-box ROI features.")
    p.add_argument("--videos_path", type=str, required=True, help="HDF5 JPEG-frame archive.")
    p.add_argument("--dataset_path", type=str, required=True,
                   help="Something-Else layout JSON (frame_objects schema).")
    p.add_argument("--save_features_path", type=str, required=True)
    p.add_argument("--resnet_model_path", type=str, default=None,
                   help="Kinetics R3D checkpoint; random init if omitted.")
    p.add_argument("--resnet_depth", type=int, default=50)
    p.add_argument("--spatial_size", type=int, default=112)
    p.add_argument("--window", type=int, default=32,
                   help="Frames per backbone invocation (static shape).")
    p.add_argument("--print_freq", type=int, default=1000)
    p.add_argument("--log_filepath", type=str, default=None)
    p.add_argument("--platform", type=str, default=None,
                   help="cpu, or the GPU (cuda) when unset.")
    return p


def perbox_features(model: Resnet3D, frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """One window's features: ``frames [window, S, S, 3]`` f32 and ``boxes
    [window, K, 4]`` in crop coordinates to ``[window, K, 9 C]`` f32. Frame
    ``i`` pools on temporal unit ``min(i T' // window, T' - 1)``."""
    window, size = frames.shape[0], frames.shape[1]
    with torch.inference_mode():
        feats = model.forward_features({"video_frames": frames[None]})[0]  # [C, T', H', W']
        feats = feats.permute(1, 2, 3, 0)  # [T', H', W', C]
        units = feats.shape[0]
        unit = (torch.arange(window, device=frames.device) * units // window).clamp(max=units - 1)
        maps = feats[unit].float()  # [window, H', W', C]
        scale = feats.shape[1] / size
        pooled = torch.stack([roi_align(fm, bx, output_size=(7, 7), spatial_scale=scale,
                                        sampling_ratio=2) for fm, bx in zip(maps, boxes)])
        return adaptive_avg_pool2d(pooled, (3, 3)).reshape(window, boxes.shape[1], -1)


def video_inputs(group, frames_meta, size: int, max_boxes: int):
    """One video's frames through the eval transform (f32 ``[N, S, S, 3]``),
    its boxes in crop coordinates, the whole frame's first (``[N, K, 4]``,
    zero-padded), and each frame's box count."""
    from PIL import Image

    from stlt_tpu_torch.data.transforms import (center_crop, center_crop_offsets,
                                                normalize_to_array, resize_shorter_side,
                                                resize_target)

    frame_ids = natural_sorted(list(group.keys()))
    frames, boxes, counts = [], [], []
    for i in range(min(len(frame_ids), len(frames_meta))):
        img = Image.open(io.BytesIO(np.asarray(group[frame_ids[i]]).tobytes())).convert("RGB")
        w0, h0 = img.size
        resized = resize_shorter_side(img, resize_target(size))
        w1, h1 = resized.size
        top, left = center_crop_offsets(h1, w1, size)
        frames.append(normalize_to_array(center_crop(resized, size)))
        raw = [[0.0, 0.0, float(w0), float(h0)]] + [
            [b["x1"], b["y1"], b["x2"], b["y2"]] for b in frames_meta[i]["frame_objects"]]
        counts.append(len(raw))
        padded = np.zeros((max_boxes, 4), np.float32)
        padded[:len(raw)] = transform_boxes(raw, (h0, w0), (h1, w1), (top, left))
        boxes.append(padded)
    return frames, boxes, counts


def video_features(model: Resnet3D, frames, boxes, window: int, device) -> np.ndarray:
    """``[N, K, 9 C]`` features of a video's N frames, ``window`` frames a
    call (the last window zero-padded)."""
    size, max_boxes = frames[0].shape[0], boxes[0].shape[0]
    feats = []
    for start in range(0, len(frames), window):
        chunk = min(window, len(frames) - start)
        f = np.zeros((window, size, size, 3), np.float32)
        b = np.zeros((window, max_boxes, 4), np.float32)
        f[:chunk] = np.stack(frames[start:start + chunk])
        b[:chunk] = np.stack(boxes[start:start + chunk])
        out = perbox_features(model, torch.from_numpy(f).to(device), torch.from_numpy(b).to(device))
        feats.append(out.cpu().numpy()[:chunk])
    return np.concatenate(feats, axis=0)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.log_filepath:
        logging.basicConfig(level=logging.INFO, filename=args.log_filepath, filemode="w")
    else:
        logging.basicConfig(level=logging.INFO)
    import h5py

    from stlt_tpu_torch.predict import resolve_device
    from stlt_tpu_torch.tools import features_file, write_video_group
    from stlt_tpu_torch.tools.dump_features import COMPUTE_DTYPE, build_extractor

    device = resolve_device(args.platform)
    with open(args.dataset_path) as f:
        json_file = json.load(f)
    # Box capacity: the most boxes in any frame, plus the whole-frame box the
    # reference prepends (dump_perbox_features.py:84).
    max_boxes = 1 + max((len(fr["frame_objects"]) for el in json_file for fr in el["frames"]),
                        default=0)
    model = build_extractor(args.resnet_depth, args.window, COMPUTE_DTYPE,
                            args.resnet_model_path, device)
    written = 0
    with h5py.File(args.videos_path, "r", libver="latest", swmr=True) as videos, \
            features_file(args.save_features_path) as (out, done):
        for index, element in enumerate(json_file):
            video_id = element["id"]
            if video_id in done or video_id not in videos:
                continue
            frames, boxes, counts = video_inputs(videos[video_id], element["frames"],
                                                 args.spatial_size, max_boxes)
            if not frames:
                continue
            feats = video_features(model, frames, boxes, args.window, device)
            datasets = {}
            for i, count in enumerate(counts):
                datasets[f"{i}-frame"] = feats[i, 0]
                for k in range(1, count):
                    datasets[f"{i}-frame-{k - 1}-box"] = feats[i, k]
            write_video_group(out, video_id, datasets)
            done.add(video_id)
            written += 1
            if index % args.print_freq == 0:
                logging.info("Current index is %d", index)
    logging.info("Wrote per-box features for %d videos to %s", written, args.save_features_path)
    return written


if __name__ == "__main__":
    main()
