"""Frame-index samplers (own copy of ``stlt_tpu/data/samplers.py``; reference
``src/utils/data_utils.py:32-90``): the layout samplers and the RGB-frame
sampler. Randomness comes from an explicit ``numpy.random.Generator``."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def sample_train_layout_indices(
    num_to_sample: int,
    num_video_frames: int,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Jittered-stratified training sampler: one uniformly jittered index
    per equal segment."""
    if rng is None:
        rng = np.random.default_rng()
    segment = num_video_frames / num_to_sample
    if segment > 0:
        starts = np.arange(num_to_sample) * segment
        picked = np.floor(starts + rng.uniform(0.0, segment, size=num_to_sample))
    else:
        picked = np.arange(num_video_frames)
    return [int(p) for p in picked]


def get_test_layout_indices(num_to_sample: int, num_video_frames: int) -> List[int]:
    """Deterministic eval sampler: segment centres; all frames when the clip
    has fewer than ``num_to_sample``."""
    if num_video_frames > num_to_sample:
        tick = num_video_frames / num_to_sample
        return [int(tick / 2.0 + tick * i) for i in range(num_to_sample)]
    return list(range(num_video_frames))


def sample_appearance_indices(
    num_to_sample: int,
    num_video_frames: int,
    train: bool,
    sample_rate: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """RGB-frame sampler (reference ``data_utils.py:59-90``): long clips take
    a stride-``sample_rate`` window (a random offset in train, centred in
    eval); short clips a sorted random choice (train) or a linspace over
    ``[0, num_video_frames - 2]``, clamped at 0."""
    if rng is None:
        rng = np.random.default_rng()
    window = num_to_sample * sample_rate
    if num_video_frames > window:
        if train:
            offset = int(rng.integers(0, num_video_frames - window))
        else:
            offset = (num_video_frames - window) // 2
        picked = list(range(offset, offset + window, sample_rate))
    elif train and num_video_frames - 2 >= num_to_sample:
        picked = np.sort(rng.choice(num_video_frames - 2, size=num_to_sample, replace=False)).tolist()
    else:
        picked = [round(p) for p in np.linspace(0, num_video_frames - 2, num_to_sample)]
    return [int(max(p, 0)) for p in picked]
