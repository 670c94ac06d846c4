"""STLT, the Spatial-Temporal Layout Transformer, eval only (batch-first).

Port of ``stlt_tpu/models/stlt.py``: ``CategoryBoxEmbeddings`` (:74),
``SpatialTransformer`` (:105), ``FramesEmbeddings`` (:195), ``StltBackbone``
(:237), ``ClassificationHead`` (:295), ``gather_extract_frame`` (:313) and
``Stlt`` (:320). The module tree and attribute names are the reference's
torch ones, so a reference-format state_dict loads with ``strict=True``
(including the dead ``layout_embedding.encoder_layer`` prototype, the
``position_ids`` buffer and ``score_embeddings``).

Padding masks derive in-model from ``categories == 0`` / ``frame_types == 0``.
Pad frames are dead rows: the spatial stage zeroes them (``rows_live``), the
temporal tail zeroes pad-frame tokens (``tokens_live``). They reach later
attention only as -1e9-masked keys, so the logits do not depend on them.
The ragged levers of the JAX package (``apply_frame_capacity``, the
live-prefix fold) are a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models.layers import (
    TransformerEncoder,
    TransformerEncoderLayer,
    activation_fn,
    apply_dense,
    apply_layer_norm,
    init_linear_,
)
from stlt_tpu_torch.ops import masks

NUM_FRAME_TYPES = 5  # reference models.py:91


def _dtype(cfg: StltModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]


def _embedding(num: int, hidden: int, generator: torch.Generator, padding_idx=None) -> nn.Embedding:
    """torch ``nn.Embedding`` default init, N(0, 1) with a zero padding row."""
    emb = nn.Embedding(num, hidden, padding_idx=padding_idx)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0, generator=generator)
        if padding_idx is not None:
            emb.weight[padding_idx].zero_()
    return emb


def _encoder(cfg: StltModelConfig, num_layers: int, generator) -> TransformerEncoder:
    return TransformerEncoder(
        num_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.hidden_size * 4,
        activation="gelu", layer_norm_eps=cfg.layer_norm_eps, dtype=_dtype(cfg),
        generator=generator,
    )


class CategoryBoxEmbeddings(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype = _dtype(cfg)
        self.eps = cfg.layer_norm_eps
        self.category_embeddings = _embedding(cfg.unique_categories, cfg.hidden_size, generator, 0)
        self.box_embedding = nn.Linear(4, cfg.hidden_size)
        self.score_embeddings = nn.Linear(1, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        init_linear_(self.box_embedding, generator)
        init_linear_(self.score_embeddings, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        emb = nn.functional.embedding(batch["categories"], self.category_embeddings.weight.to(dt))
        emb = emb + apply_dense(batch["boxes"], self.box_embedding, dt)
        if "scores" in batch:
            # Only Action Genome batches carry detector scores.
            emb = emb + apply_dense(batch["scores"][..., None], self.score_embeddings, dt)
        return apply_layer_norm(emb, self.layer_norm.weight, self.layer_norm.bias, self.eps, dt)


class SpatialTransformer(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.category_box_embeddings = CategoryBoxEmbeddings(cfg, generator)
        # The reference keeps its prototype layer as an attribute; its
        # parameters are in every checkpoint and never run.
        self.encoder_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.hidden_size * 4,
            activation="gelu", layer_norm_eps=cfg.layer_norm_eps, dtype=_dtype(cfg),
            generator=generator,
        )
        self.transformer = _encoder(cfg, cfg.num_spatial_layers, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = self.category_box_embeddings(batch)  # [B, F, O, H]
        B, F, O, H = tokens.shape
        pad_bias = masks.key_padding_bias(
            masks.boxes_padding_mask(batch["categories"]).reshape(B * F, O)
        )
        # Pad-frame compaction: rows of pad frames are dead downstream.
        rows_live = (batch["frame_types"] != 0).reshape(B * F)
        tokens = self.transformer(tokens.reshape(B * F, O, H), pad_bias, rows_live=rows_live)
        return tokens[:, 0, :].reshape(B, F, H)  # the frame-CLS token


class FramesEmbeddings(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype = _dtype(cfg)
        self.eps = cfg.layer_norm_eps
        self.layout_num_frames = cfg.layout_num_frames
        self.layout_embedding = SpatialTransformer(cfg, generator)
        self.position_embeddings = _embedding(cfg.layout_num_frames, cfg.hidden_size, generator)
        self.frame_type_embedding = _embedding(NUM_FRAME_TYPES, cfg.hidden_size, generator, 0)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.register_buffer(
            "position_ids", torch.arange(cfg.layout_num_frames).expand((1, -1))
        )

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        frames = self.layout_embedding(batch)
        num_frames = frames.shape[1]
        if num_frames > self.layout_num_frames:
            raise ValueError(
                f"clip has {num_frames} frames but the position table holds "
                f"{self.layout_num_frames}; size the model config with "
                f"configs.position_table_rows(data_config)"
            )
        positions = self.position_embeddings.weight[None, :num_frames].to(dt)
        types = nn.functional.embedding(batch["frame_types"], self.frame_type_embedding.weight.to(dt))
        emb = frames + positions + types
        return apply_layer_norm(emb, self.layer_norm.weight, self.layer_norm.bias, self.eps, dt)


class StltBackbone(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.frames_embeddings = FramesEmbeddings(cfg, generator)
        self.transformer = _encoder(cfg, cfg.num_temporal_layers, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        emb = self.frames_embeddings(batch)
        num_frames = emb.shape[1]
        bias = masks.causal_bias(num_frames, emb.device) + masks.key_padding_bias(
            masks.frames_padding_mask(batch["frame_types"])
        )
        tokens_live = batch["frame_types"] != 0
        return self.transformer(emb, bias, tokens_live=tokens_live)  # [B, F, H]


class ClassificationHead(nn.Module):
    """fc1 -> GELU -> LayerNorm -> fc2 (reference models.py:155-163)."""

    def __init__(self, hidden_size: int, num_classes: int, layer_norm_eps: float,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.eps = layer_norm_eps
        self.fc1 = nn.Linear(hidden_size, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.fc2 = nn.Linear(hidden_size, num_classes)
        init_linear_(self.fc1, generator)
        init_linear_(self.fc2, generator)

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        h = activation_fn("gelu", self.dtype)(apply_dense(hidden_state, self.fc1, self.dtype))
        h = apply_layer_norm(h, self.layer_norm.weight, self.layer_norm.bias, self.eps, self.dtype)
        return apply_dense(h, self.fc2, self.dtype)


def gather_extract_frame(hidden_states: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The hidden state at frame ``lengths - 1``, the appended EXTRACT frame.
    [B, F, H] -> [B, H]."""
    rows = torch.arange(hidden_states.shape[0], device=hidden_states.device)
    return hidden_states[rows, lengths.long() - 1]


class Stlt(nn.Module):
    logit_names = ("stlt",)

    def __init__(self, config: StltModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.backbone = StltBackbone(config, generator)
        self.prediction_head = ClassificationHead(
            config.hidden_size, config.num_classes, config.layer_norm_eps,
            _dtype(config), generator,
        )

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.training:
            raise RuntimeError("the port serves the eval path only: call model.eval()")
        hidden = self.backbone(batch)
        pooled = gather_extract_frame(hidden, batch["lengths"])
        return {"stlt": self.prediction_head(pooled).to(torch.float32)}
