"""Appearance (RGB) dataset: JPEG frames -> fixed-shape frames.

Own copy of ``stlt_tpu/data/appearance.py`` (reference
``AppearanceDataset``, ``src/modelling/datasets.py:139-208``): one HDF5 group
per video id holding one JPEG-bytes dataset per frame index, opened lazily
(SWMR) on first use; the stride-2 window sampler
(``samplers.sample_appearance_indices``); resize to 128, then the shared
random crop and per-clip colour jitter in train or the centre crop in eval,
to 112 px; mean/std 0.5. The output is channel-last ``[T, S, S, 3]`` f32, or
uint8 with ``device_normalize`` (the model normalises on the device).

h5py and Pillow are imported where the frames are read, so importing the
port loads neither. ``--native_decode`` decodes, resizes and jitters the
frames in the C++ stage (``data/native_jpeg.py``), drawing the generator in
the PIL route's order, as JAX's ``_native_frames`` does, so a seed gives the
same clip either way. Where JAX routes a frame the C++ stage refuses through
PIL with a warning, the port raises, naming the clip and the frame; a stage
that does not build raises with the compiler's words.
"""

from __future__ import annotations

import io
import json
import re
from typing import Dict, List, Optional

import numpy as np

from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data.samplers import sample_appearance_indices
from stlt_tpu_torch.data.transforms import (
    VideoColorJitter,
    center_crop,
    center_crop_offsets,
    crop,
    normalize_to_array,
    random_crop_params,
    resize_shorter_side,
    resize_target,
)

_TEMPLATE_BRACKETS = re.compile(r"[\[\]]")


class AppearanceDataset:
    def __init__(self, config: DataConfig, json_file: Optional[List[dict]] = None):
        self.config = config
        if json_file is None:
            with open(config.dataset_path) as f:
                json_file = json.load(f)
        self.json_file = json_file
        with open(config.labels_path) as f:
            self.labels = json.load(f)
        self._videos = None
        self._resize_to = resize_target(config.spatial_size)

    def __len__(self) -> int:
        return len(self.json_file)

    @property
    def videos(self):
        if self._videos is None:
            import h5py

            self._videos = h5py.File(self.config.videos_path, "r", libver="latest", swmr=True)
        return self._videos

    def _load_frame(self, group, index):
        from PIL import Image

        img = Image.open(io.BytesIO(np.asarray(group[str(index)])))
        if self.config.fast_decode:
            # JPEG DCT-scaled decode to at least the target size.
            img.draft("RGB", (self._resize_to, self._resize_to))
        return resize_shorter_side(img.convert("RGB"), self._resize_to)

    def _native_frames(self, video_id, group, indices) -> List[np.ndarray]:
        """Every sampled frame decoded and resized by the C++ stage, uint8
        ``[H, W, 3]``; raises on a frame it cannot decode."""
        from stlt_tpu_torch.data.native_jpeg import decode_resize

        frames = []
        for i in indices:
            frame = decode_resize(np.asarray(group[str(i)]).tobytes(), self._resize_to,
                                  draft=self.config.fast_decode)
            if frame is None:
                raise ValueError(f"--native_decode: the C++ JPEG stage cannot decode frame {i} "
                                 f"of clip {video_id} in {self.config.videos_path}")
            frames.append(frame)
        return frames

    def _native_clip(self, video_id, group, indices, rng) -> np.ndarray:
        """The clip through the C++ stage, uint8 ``[T, S, S, 3]``: the
        generator drawn as the PIL route draws it (the jitter, then the
        crop)."""
        from stlt_tpu_torch.data.native_jpeg import jitter_rgb

        frames = self._native_frames(video_id, group, indices)
        size = self.config.spatial_size
        if self.config.train:
            jitter = VideoColorJitter(rng)
            top, left, h, w = random_crop_params(frames[0], size, rng)
            for frame in frames:
                jitter_rgb(frame, jitter)
        else:
            top, left = center_crop_offsets(*frames[0].shape[:2], size)
            h = w = size
        return np.stack([f[top:top + h, left:left + w] for f in frames])

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if rng is None:
            rng = np.random.default_rng()
        video_id = self.json_file[idx]["id"]
        group = self.videos[video_id]
        indices = sample_appearance_indices(cfg.appearance_num_frames, len(group), cfg.train, rng=rng)
        if cfg.native_decode:
            video = self._native_clip(video_id, group, indices, rng)
            if not cfg.device_normalize:
                video = normalize_to_array(video)
        else:
            frames = [self._load_frame(group, i) for i in indices]
            if cfg.train:
                jitter = VideoColorJitter(rng)
                top, left, h, w = random_crop_params(frames[0], cfg.spatial_size, rng)
                frames = [crop(jitter(f), top, left, h, w) for f in frames]
            else:
                frames = [center_crop(f, cfg.spatial_size) for f in frames]
            if cfg.device_normalize:
                video = np.stack([np.asarray(f, dtype=np.uint8) for f in frames])
            else:
                video = np.stack([normalize_to_array(f) for f in frames])  # [T, S, S, 3]
        template = _TEMPLATE_BRACKETS.sub("", self.json_file[idx]["template"])
        label = np.asarray(int(self.labels[template]), dtype=np.int32)
        return {"video_id": video_id, "video_frames": video, "labels": label}


def collate_appearance(samples: List[Dict]) -> Dict[str, np.ndarray]:
    return {
        "video_frames": np.stack([s["video_frames"] for s in samples]),
        "labels": np.stack([s["labels"] for s in samples]),
    }
