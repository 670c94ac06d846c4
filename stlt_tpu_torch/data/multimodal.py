"""Multimodal dataset: paired layout and appearance clips over one JSON.

Own copy of ``stlt_tpu/data/multimodal.py`` (reference ``MultimodalDataset``
/ ``MultiModalCollater``, ``src/modelling/datasets.py:211-229, 303-319``): the
layout and the RGB frame indices are sampled independently, from one
generator, layout first.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data.appearance import AppearanceDataset, collate_appearance
from stlt_tpu_torch.data.layout import LayoutDataset, collate_layout


class MultimodalDataset:
    def __init__(self, config: DataConfig):
        self.config = config
        self.layout_dataset = LayoutDataset(config)
        self.appearance_dataset = AppearanceDataset(config, self.layout_dataset.json_file)
        self.labels = self.layout_dataset.labels

    def __len__(self) -> int:
        return len(self.layout_dataset)

    def max_video_frames(self) -> int:
        return self.layout_dataset.max_video_frames()

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        return {
            "layout": self.layout_dataset.__getitem__(idx, rng=rng),
            "appearance": self.appearance_dataset.__getitem__(idx, rng=rng),
        }


def make_collate_multimodal(config: DataConfig):
    def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
        batch = collate_layout([s["layout"] for s in samples], config.dataset_name)
        batch["video_frames"] = collate_appearance([s["appearance"] for s in samples])["video_frames"]
        return batch

    return collate
