"""Layout (bounding-box) dataset: JSON annotations -> fixed-shape numpy clips.

Own copy of ``stlt_tpu/data/layout.py`` (reference
``src/modelling/datasets.py:32-136`` and the StltCollater at ``:239-288``):

- init scans the JSON for the max count of score-thresholded objects and
  overwrites ``config.max_num_objects``;
- token 0 of every frame is a CLS pseudo-box ``[0,0,1,1]`` (category
  ``cls``, score 1.0); real objects are thresholded, repaired by
  ``fix_box`` and normalised by ``[W,H,W,H]``;
- a CLS-only EXTRACT frame follows the sampled frames; ``lengths`` counts
  both;
- every clip is padded to the static ``[layout_num_frames + 1,
  max_num_objects + 1]`` with CLS-carrying pad frames (type ``pad``).
"""

from __future__ import annotations

import json
import logging
import re
from typing import Dict, List, Optional

import numpy as np

from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data.boxes import fix_box
from stlt_tpu_torch.data.samplers import get_test_layout_indices, sample_train_layout_indices

_TEMPLATE_BRACKETS = re.compile(r"[\[\]]")


def scan_max_objects(json_file: List[dict], score_threshold: float) -> int:
    """Max number of score-thresholded objects in any frame; raises on a
    dataset without frames."""
    max_objects = -1
    for video in json_file:
        for frame in video["frames"]:
            count = sum(1 for obj in frame["frame_objects"] if obj["score"] >= score_threshold)
            max_objects = max(max_objects, count)
    if max_objects < 0:
        raise ValueError(
            f"scan_max_objects: dataset has no frames at all across "
            f"{len(json_file)} videos — empty dataset or wrong JSON schema"
        )
    if max_objects == 0:
        logging.warning(
            "scan_max_objects: no object passed score_threshold=%s in any "
            "frame; clips will carry CLS tokens only", score_threshold,
        )
    return max_objects


class LayoutDataset:
    """Produces per-clip dicts of fixed-shape numpy arrays."""

    def __init__(self, config: DataConfig, json_file: Optional[List[dict]] = None):
        self.config = config
        if json_file is None:
            with open(config.dataset_path) as f:
                json_file = json.load(f)
        self.json_file = json_file
        with open(config.labels_path) as f:
            self.labels = json.load(f)
        with open(config.videoid2size_path) as f:
            self.videoid2size = json.load(f)
        self.config.max_num_objects = scan_max_objects(self.json_file, config.score_threshold)
        self._cls_id = config.category2id["cls"]
        f2t = config.frame2type
        self._type_pad = f2t["pad"]
        self._type_regular = f2t["regular"]
        self._type_empty = f2t["empty"]
        self._type_extract = f2t["extract"]
        self._multilabel = config.dataset_name == "action_genome"

    def __len__(self) -> int:
        return len(self.json_file)

    def _blank_frame(self, num_boxes: int):
        categories = np.zeros((num_boxes,), dtype=np.int32)
        categories[0] = self._cls_id
        boxes = np.zeros((num_boxes, 4), dtype=np.float32)
        boxes[0] = (0.0, 0.0, 1.0, 1.0)
        scores = np.zeros((num_boxes,), dtype=np.float32)
        scores[0] = 1.0
        return categories, boxes, scores

    def get_actions(self, sample: dict) -> np.ndarray:
        if self._multilabel:
            actions = np.zeros((len(self.labels),), dtype=np.float32)
            for action in sample["actions"]:
                actions[int(action[1:])] = 1.0
            return actions
        template = _TEMPLATE_BRACKETS.sub("", sample["template"])
        return np.asarray(int(self.labels[template]), dtype=np.int32)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        sample = self.json_file[idx]
        video_id = sample["id"]
        width, height = self.videoid2size[video_id]
        wh = np.asarray([width, height, width, height], dtype=np.float32)
        frames = sample["frames"]
        if cfg.train:
            indices = sample_train_layout_indices(cfg.layout_num_frames, len(frames), rng=rng)
        else:
            indices = get_test_layout_indices(cfg.layout_num_frames, len(frames))

        F_total = cfg.num_total_frames
        O = cfg.num_total_boxes
        categories = np.zeros((F_total, O), dtype=np.int32)
        boxes = np.zeros((F_total, O, 4), dtype=np.float32)
        scores = np.zeros((F_total, O), dtype=np.float32)
        frame_types = np.full((F_total,), self._type_pad, dtype=np.int32)
        blank_cat, blank_box, blank_score = self._blank_frame(O)

        for f, index in enumerate(indices):
            objs = frames[index]["frame_objects"]
            frame_types[f] = self._type_empty if len(objs) == 0 else self._type_regular
            categories[f] = blank_cat
            boxes[f] = blank_box
            scores[f] = blank_score
            slot = 1
            for obj in objs:
                if obj["score"] < cfg.score_threshold:
                    continue
                fixed = fix_box((obj["x1"], obj["y1"], obj["x2"], obj["y2"]), (height, width))
                boxes[f, slot] = np.asarray(fixed, dtype=np.float32) / wh
                categories[f, slot] = cfg.category2id[obj["category"]]
                scores[f, slot] = obj["score"]
                slot += 1

        extract_pos = len(indices)
        frame_types[extract_pos] = self._type_extract
        # The EXTRACT frame and the pad frames after it carry the CLS token.
        for f in range(extract_pos, F_total):
            categories[f] = blank_cat
            boxes[f] = blank_box
            scores[f] = blank_score

        return {
            "video_id": video_id,
            "categories": categories,
            "boxes": boxes,
            "scores": scores,
            "frame_types": frame_types,
            "lengths": np.asarray(extract_pos + 1, dtype=np.int32),
            "labels": self.get_actions(sample),
        }


def collate_layout(samples: List[Dict], dataset_name: str) -> Dict[str, np.ndarray]:
    """Stack fixed-shape clips into a batch; scores only for action_genome
    (the reference's conditional score embedding)."""
    batch = {
        key: np.stack([s[key] for s in samples])
        for key in ("categories", "boxes", "frame_types", "lengths", "labels")
    }
    if dataset_name == "action_genome":
        batch["scores"] = np.stack([s["scores"] for s in samples])
    return batch
