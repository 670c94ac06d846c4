"""The C++ layout tokenizer (``native/layout_tokenizer.cpp``) behind the
port's ``LayoutDataset`` interface.

Own copy of ``stlt_tpu/data/native.py``: the library parses the dataset
JSON once into an arena and fills each clip's fixed-shape buffers (CLS
pseudo-box, score threshold, ``fix_box``, ``[W, H, W, H]`` normalisation,
the extract frame, CLS-carrying pad frames), bit for bit the Python
dataset's clips (``data/layout.py``, its plain version). The frame samplers
stay the port's (``data/samplers.py``), so a seeded generator draws the same
frames either way.

It is ``datasets_factory["layout"]``; ``MultimodalDataset`` keeps the Python
dataset, as JAX's does. The library is built with g++ at first use
(``data/_native_build.py``); a failed build raises. The arena is freed once,
when the last reference to the dataset goes (a ``weakref.finalize``: the
loader's threads hold it while they run); every rank is a process that
parses its own.
"""

from __future__ import annotations

import ctypes
import json
import re
import threading
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data._native_build import load_shared_library
from stlt_tpu_torch.data.samplers import get_test_layout_indices, sample_train_layout_indices

SRC = Path(__file__).resolve().parents[1] / "native" / "layout_tokenizer.cpp"
_TEMPLATE_BRACKETS = re.compile(r"[\[\]]")
_ERR_LEN = 512
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)

_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The tokenizer's library, built at first use; raises if it does not
    build."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = load_shared_library(SRC, "layout_tokenizer")
            P, I, D, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
            lib.lt_parse.restype = P
            lib.lt_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, I]
            lib.lt_num_videos.argtypes = [P]
            lib.lt_video_num_frames.argtypes = [P, I]
            lib.lt_video_id.restype = ctypes.c_char_p
            lib.lt_video_id.argtypes = [P, I]
            lib.lt_video_meta.restype = ctypes.c_char_p
            lib.lt_video_meta.argtypes = [P, I]
            lib.lt_set_size.argtypes = [P, I, F, F]
            lib.lt_scan_max_objects.restype = I
            lib.lt_scan_max_objects.argtypes = [P, D]
            lib.lt_tokenize.restype = I
            # handle, clip, frame indices and their count, score threshold,
            # the cls id, the pad/regular/empty/extract frame types, frames
            # and boxes a clip, categories, boxes, scores, frame_types
            lib.lt_tokenize.argtypes = [P, I, _I32P, I, D, I, I, I, I, I, I, I,
                                        _I32P, _F32P, _F32P, _I32P]
            lib.lt_free.argtypes = [P]
            _lib = lib
        return _lib


class NativeLayoutDataset:
    """Per-clip dicts of fixed-shape numpy arrays, as ``LayoutDataset``
    gives them, from the C++ arena."""

    def __init__(self, config: DataConfig):
        lib = load_library()
        self.config = config
        err = ctypes.create_string_buffer(_ERR_LEN)
        handle = lib.lt_parse(config.dataset_path.encode(), json.dumps(config.category2id).encode(),
                              err, _ERR_LEN)
        if not handle:
            raise ValueError(f"the layout tokenizer could not parse {config.dataset_path}: "
                             f"{err.value.decode()}")
        self._lib, self._handle = lib, handle
        self._free = weakref.finalize(self, lib.lt_free, handle)
        with open(config.labels_path) as f:
            self.labels = json.load(f)
        with open(config.videoid2size_path) as f:
            videoid2size = json.load(f)
        self.video_ids: List[str] = []
        for i in range(lib.lt_num_videos(handle)):
            video_id = lib.lt_video_id(handle, i).decode()
            self.video_ids.append(video_id)
            width, height = videoid2size[video_id]
            lib.lt_set_size(handle, i, float(width), float(height))
        # The reference overwrites the config's max_num_objects with the scan.
        max_objects = lib.lt_scan_max_objects(handle, config.score_threshold)
        if max_objects < 0:
            raise ValueError(f"{config.dataset_path} has no frames at all across "
                             f"{len(self.video_ids)} videos: empty dataset or wrong JSON schema")
        self.config.max_num_objects = max_objects
        self._num_frames = [lib.lt_video_num_frames(handle, i) for i in range(len(self.video_ids))]
        self._multilabel = config.dataset_name == "action_genome"

    def __len__(self) -> int:
        return len(self.video_ids)

    def max_video_frames(self) -> int:
        """The longest clip's frame count (the ragged levers' capacity scans,
        ``configs.spatial_live_capacity_for``)."""
        return max(self._num_frames, default=0)

    def get_actions(self, idx: int) -> np.ndarray:
        """Clip ``idx``'s label: a class index, or Action Genome's multi-hot
        actions."""
        meta = self._lib.lt_video_meta(self._handle, idx).decode()
        if self._multilabel:
            actions = np.zeros((len(self.labels),), dtype=np.float32)
            for action in meta.split(";"):
                if action:
                    actions[int(action[1:])] = 1.0
            return actions
        return np.asarray(int(self.labels[_TEMPLATE_BRACKETS.sub("", meta)]), dtype=np.int32)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        num_frames = self._num_frames[idx]
        if cfg.train:
            indices = sample_train_layout_indices(cfg.layout_num_frames, num_frames, rng=rng)
        else:
            indices = get_test_layout_indices(cfg.layout_num_frames, num_frames)
        F_total, O = cfg.num_total_frames, cfg.num_total_boxes
        categories = np.empty((F_total, O), dtype=np.int32)
        boxes = np.empty((F_total, O, 4), dtype=np.float32)
        scores = np.empty((F_total, O), dtype=np.float32)
        frame_types = np.empty((F_total,), dtype=np.int32)
        picked = np.asarray(indices, dtype=np.int32)
        f2t = cfg.frame2type
        rc = self._lib.lt_tokenize(
            self._handle, idx, picked.ctypes.data_as(_I32P), len(indices), cfg.score_threshold,
            cfg.category2id["cls"], f2t["pad"], f2t["regular"], f2t["empty"], f2t["extract"],
            F_total, O, categories.ctypes.data_as(_I32P), boxes.ctypes.data_as(_F32P),
            scores.ctypes.data_as(_F32P), frame_types.ctypes.data_as(_I32P),
        )
        if rc == -1:
            raise KeyError(f"an unknown category in clip {self.video_ids[idx]}")
        if rc != 0:
            raise IndexError(f"the layout tokenizer failed ({rc}) on clip {idx}")
        return {
            "video_id": self.video_ids[idx],
            "categories": categories,
            "boxes": boxes,
            "scores": scores,
            "frame_types": frame_types,
            "lengths": np.asarray(len(indices) + 1, dtype=np.int32),
            "labels": self.get_actions(idx),
        }
