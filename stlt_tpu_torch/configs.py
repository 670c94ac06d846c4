"""Configuration dataclasses of the PyTorch port.

Own copy of ``stlt_tpu/configs.py`` (``DataConfig`` :113,
``GeneralModelConfig`` :180, ``StltModelConfig`` :209,
``AppearanceModelConfig`` :227, ``MultimodalModelConfig`` :240, the
vocabularies :26-105, ``position_table_rows`` :298,
``spatial_live_capacity_for`` :311, ``frame_capacity_for`` :341,
``make_model_config`` :365 and ``model_configs_factory`` :373),
and of ``stlt_tpu/train.py::_live_prefix_caps`` (:40-59, here
``live_prefix_caps``, which ``inference`` calls). The capacity helpers have
no environment switches: ``--live_prefix`` alone turns them on; unlike JAX's
they bound a train config by its whole frame axis (``_max_live_frames``), so
a train set allows no cut and ``train`` computes none.
The port imports nothing from ``stlt_tpu``, so the
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
    # Appearance-pipeline options (data/appearance.py); the layout path
    # ignores them.
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
    # Per-layer activation checkpointing of the encoders in training
    # (models/layers.TransformerEncoder).
    remat: bool = False
    # Ragged levers (models/stlt.py): the static row count the spatial
    # encoder runs at after the live rows are folded to a prefix, and the
    # frame-axis length the layout branch runs at; None = uncut. The weights
    # do not depend on them.
    spatial_live_capacity: Optional[int] = None
    temporal_frame_capacity: Optional[int] = None

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


def _max_live_frames(dataset, data_config: DataConfig) -> Optional[int]:
    """Bound of every clip's live frame slots: the longest clip, capped at
    ``layout_num_frames``, plus the extract slot; None without a bound. A
    train config's bound is the whole ``layout_num_frames + 1``: the jittered
    train sampler (``data/samplers.py``) picks ``layout_num_frames`` indices
    from every clip with a frame, repeating the frames of shorter clips. (The
    JAX package bounds train sets by their longest clip too, so its
    ``train --live_prefix`` cuts sampled frames; ``ROADMAP.md`` section C.)"""
    if data_config.train:
        return data_config.layout_num_frames + 1
    scan = getattr(dataset, "max_video_frames", None)
    max_frames = scan() if scan is not None else 0
    if max_frames <= 0:
        return None
    return min(max_frames, data_config.layout_num_frames) + 1


def spatial_live_capacity_for(dataset, data_config: DataConfig, batch_size: int,
                              frame_axis: Optional[int] = None) -> Optional[int]:
    """Live-prefix capacity that holds for every batch of ``dataset``:
    ``batch_size`` times the live-slot bound, rounded up to 8, or None when
    it would not cut the ``batch_size x frame_axis`` rows (``frame_axis``:
    the frame slots the model runs at, ``num_total_frames`` by default)."""
    max_live = _max_live_frames(dataset, data_config)
    if max_live is None:
        return None
    total = batch_size * (frame_axis or data_config.num_total_frames)
    cap = min(total, ((batch_size * max_live + 7) // 8) * 8)
    return None if cap >= total else cap


def frame_capacity_for(dataset, data_config: DataConfig) -> Optional[int]:
    """Frame capacity that holds for every clip of ``dataset``: the
    live-slot bound rounded up to 8, or None when it would not cut the
    frame axis."""
    max_live = _max_live_frames(dataset, data_config)
    if max_live is None:
        return None
    total = data_config.num_total_frames
    cap = min(total, ((max_live + 7) // 8) * 8)
    return None if cap >= total else cap


def live_prefix_caps(args, *dataset_cfgs):
    """The CLIs' ``--live_prefix --use_pallas``: (spatial_live_capacity,
    temporal_frame_capacity) that hold for every (dataset, data config) the
    model sees, each None where a bound is missing or the lever would not
    cut; both None without the two flags or under context parallelism (the
    ring shards the frame axis). Own copy of ``stlt_tpu/train.py::
    _live_prefix_caps`` (:40-59)."""
    if not (args.live_prefix and args.use_pallas) or args.context_parallel > 1:
        return None, None
    fcaps = [frame_capacity_for(ds, cfg) for ds, cfg in dataset_cfgs]
    frame_cap = None if any(c is None for c in fcaps) else max(fcaps)
    caps = [spatial_live_capacity_for(ds, cfg, args.batch_size, frame_axis=frame_cap)
            for ds, cfg in dataset_cfgs]
    return (None if any(c is None for c in caps) else max(caps)), frame_cap


@dataclasses.dataclass
class AppearanceModelConfig(GeneralModelConfig):
    appearance_num_frames: int = 0
    resnet_model_path: Optional[str] = None
    num_appearance_layers: int = 4
    # R3D depth (10-200; the reference hardcodes 50).
    resnet_depth: int = 50

    def __post_init__(self):
        super().__post_init__()
        assert self.appearance_num_frames, "appearance_num_frames must not be None!"


@dataclasses.dataclass
class MultimodalModelConfig(GeneralModelConfig):
    unique_categories: int = 0
    num_spatial_layers: int = 4
    num_temporal_layers: int = 8
    layout_num_frames: int = 256
    appearance_num_frames: int = 0
    resnet_model_path: Optional[str] = None
    num_appearance_layers: int = 4
    resnet_depth: int = 50
    num_fusion_layers: int = 4
    load_backbone_path: Optional[str] = None
    freeze_backbone: bool = False

    @property
    def stlt_config(self) -> StltModelConfig:
        """The layout branch's config."""
        return StltModelConfig(
            num_classes=self.num_classes,
            hidden_size=self.hidden_size,
            hidden_dropout_prob=self.hidden_dropout_prob,
            layer_norm_eps=self.layer_norm_eps,
            num_attention_heads=self.num_attention_heads,
            compute_dtype=self.compute_dtype,
            use_pallas=self.use_pallas,
            remat=self.remat,
            unique_categories=self.unique_categories,
            num_spatial_layers=self.num_spatial_layers,
            num_temporal_layers=self.num_temporal_layers,
            layout_num_frames=self.layout_num_frames,
            spatial_live_capacity=self.spatial_live_capacity,
            temporal_frame_capacity=self.temporal_frame_capacity,
        )

    @property
    def appearance_config(self) -> AppearanceModelConfig:
        """The appearance branch's config."""
        return AppearanceModelConfig(
            num_classes=self.num_classes,
            hidden_size=self.hidden_size,
            hidden_dropout_prob=self.hidden_dropout_prob,
            layer_norm_eps=self.layer_norm_eps,
            num_attention_heads=self.num_attention_heads,
            compute_dtype=self.compute_dtype,
            use_pallas=self.use_pallas,
            remat=self.remat,
            appearance_num_frames=self.appearance_num_frames,
            resnet_model_path=self.resnet_model_path,
            num_appearance_layers=self.num_appearance_layers,
            resnet_depth=self.resnet_depth,
        )


model_configs_factory = {
    "stlt": StltModelConfig,
    "resnet3d": AppearanceModelConfig,
    "resnet3d-transformer": AppearanceModelConfig,
    "lcf": MultimodalModelConfig,
    "caf": MultimodalModelConfig,
    "cacnf": MultimodalModelConfig,
}


def make_model_config(model_name: str, **kwargs):
    """Build the config of ``model_name`` from a flat kwargs dict, keeping
    only the fields it has and the values that are not None."""
    cls = model_configs_factory[model_name]
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kwargs.items() if k in fields and v is not None})
