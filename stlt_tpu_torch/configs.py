"""Configuration dataclasses of the PyTorch port.

Own copy of ``stlt_tpu/configs.py`` (``DataConfig`` :113,
``GeneralModelConfig`` :180, ``StltModelConfig`` :209, the vocabularies
:26-105, ``position_table_rows`` :298 and ``make_model_config`` :365 for
``"stlt"``). The port imports nothing from ``stlt_tpu``, so the
vocabularies and defaults are repeated here; tests hold the two copies
equal.

``compute_dtype`` and ``use_pallas`` are parsed as in the JAX package. In the
port ``use_pallas`` does not change the dispatch: a CUDA tensor always runs
the hand-written kernels and a CPU tensor their plain versions
(``ops/fused_encoder.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

SOMETHING_CATEGORY2ID: Dict[str, int] = {
    "pad": 0,
    "hand": 1,
    "object": 2,
    "cls": 3,
}

ACTION_GENOME_CATEGORY2ID: Dict[str, int] = {
    "pad": 0,
    "cls": 1,
    "chair": 2,
    "book": 3,
    "medicine": 4,
    "vacuum": 5,
    "food": 6,
    "groceries": 7,
    "floor": 8,
    "mirror": 9,
    "closet/cabinet": 10,
    "doorway": 11,
    "paper/notebook": 12,
    "picture": 13,
    "phone/camera": 14,
    "sofa/couch": 15,
    "sandwich": 16,
    "cup/glass/bottle": 17,
    "towel": 18,
    "box": 19,
    "blanket": 20,
    "television": 21,
    "bag": 22,
    "refrigerator": 23,
    "table": 24,
    "light": 25,
    "broom": 26,
    "shoe": 27,
    "doorknob": 28,
    "bed": 29,
    "window": 30,
    "shelf": 31,
    "door": 32,
    "pillow": 33,
    "laptop": 34,
    "dish": 35,
    "clothes": 36,
    "person": 37,
}

SOMETHING_FRAME2TYPE: Dict[str, int] = {
    "pad": 0,
    "start": 1,
    "regular": 2,
    "empty": 3,
    "extract": 4,
}

ACTION_GENOME_FRAME2TYPE: Dict[str, int] = {
    "pad": 0,
    "regular": 1,
    "extract": 2,
    "empty": 3,
}

DATASET_NAMES = ("something", "action_genome")


def category2id_for(dataset_name: str) -> Dict[str, int]:
    if dataset_name == "something":
        return SOMETHING_CATEGORY2ID
    if dataset_name == "action_genome":
        return ACTION_GENOME_CATEGORY2ID
    raise ValueError(f"{dataset_name} does not exist!")


def frame2type_for(dataset_name: str) -> Dict[str, int]:
    if dataset_name == "something":
        return SOMETHING_FRAME2TYPE
    if dataset_name == "action_genome":
        return ACTION_GENOME_FRAME2TYPE
    raise ValueError(f"{dataset_name} does not exist!")


@dataclasses.dataclass
class DataConfig:
    dataset_name: str
    dataset_path: Optional[str] = None
    labels_path: Optional[str] = None
    videoid2size_path: Optional[str] = None
    videos_path: Optional[str] = None
    train: bool = False
    layout_num_frames: int = 16
    max_num_objects: int = 7
    score_threshold: float = 0.5
    appearance_num_frames: int = 32
    spatial_size: int = 112
    # Round the static frame axis up to a multiple; pad frames are inert.
    frames_multiple: int = 1
    # Appearance-pipeline options, parsed for flag parity with the JAX
    # package; the layout path ignores them.
    fast_decode: bool = False
    native_decode: bool = False
    device_normalize: bool = False

    def __post_init__(self):
        if self.dataset_name not in DATASET_NAMES:
            raise ValueError(f"{self.dataset_name} does not exist!")

    @property
    def category2id(self) -> Dict[str, int]:
        return category2id_for(self.dataset_name)

    @property
    def frame2type(self) -> Dict[str, int]:
        return frame2type_for(self.dataset_name)

    @property
    def num_total_frames(self) -> int:
        """Static frame axis: sampled frames + the appended EXTRACT frame,
        rounded up to ``frames_multiple``."""
        base = self.layout_num_frames + 1
        m = max(self.frames_multiple, 1)
        return ((base + m - 1) // m) * m

    @property
    def num_total_boxes(self) -> int:
        """Static box axis: CLS pseudo-box + max_num_objects real boxes."""
        return self.max_num_objects + 1


@dataclasses.dataclass
class GeneralModelConfig:
    num_classes: int = 0
    hidden_size: int = 768
    hidden_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    num_attention_heads: int = 12
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # Parsed for flag parity; the port dispatches on the tensor's device.
    use_pallas: bool = False
    remat: bool = False

    def __post_init__(self):
        assert self.num_classes, "num_classes must not be None!"


@dataclasses.dataclass
class StltModelConfig(GeneralModelConfig):
    unique_categories: int = 0
    num_spatial_layers: int = 4
    num_temporal_layers: int = 8
    # Position-table rows: 256 in the reference (its train.py never passes
    # the data config's frame count through).
    layout_num_frames: int = 256
    load_backbone_path: Optional[str] = None
    freeze_backbone: bool = False

    def __post_init__(self):
        super().__post_init__()
        assert self.unique_categories, "unique_categories must not be None!"


def position_table_rows(data_config: DataConfig) -> int:
    """Frame-position-table rows for a model driven by ``data_config``: the
    reference's 256, grown with the padded frame axis for longer clips."""
    return max(StltModelConfig.layout_num_frames, data_config.num_total_frames)


model_configs_factory = {"stlt": StltModelConfig}


def make_model_config(model_name: str, **kwargs):
    """Build the config of ``model_name`` from a flat kwargs dict, keeping
    only the fields it has and the values that are not None."""
    cls = model_configs_factory[model_name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields and v is not None})
