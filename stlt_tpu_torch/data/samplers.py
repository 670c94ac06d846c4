"""Layout frame-index samplers (own copy of the layout samplers of
``stlt_tpu/data/samplers.py``; reference ``src/utils/data_utils.py:32-56``).
Randomness comes from an explicit ``numpy.random.Generator``."""

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
