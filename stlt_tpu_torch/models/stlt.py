"""STLT, the Spatial-Temporal Layout Transformer, eval and train (batch-first).

Port of ``stlt_tpu/models/stlt.py``: ``apply_frame_capacity`` (:49),
``CategoryBoxEmbeddings`` (:74), ``SpatialTransformer`` (:105),
``FramesEmbeddings`` (:195), ``StltBackbone`` (:237), ``ClassificationHead``
(:295), ``gather_extract_frame`` (:313) and ``Stlt`` (:320). The module tree and attribute names are the reference's
torch ones, so a reference-format state_dict loads with ``strict=True``
(including the dead ``layout_embedding.encoder_layer`` prototype, the
``position_ids`` buffer and ``score_embeddings``).

Padding masks derive in-model from ``categories == 0`` / ``frame_types == 0``.
Pad frames are dead rows: the spatial stage zeroes them (``rows_live``), the
temporal tail zeroes pad-frame tokens (``tokens_live``). They reach later
attention only as masked keys, so the logits do not depend on them. The
temporal encoder is causal and gets each clip's live frame count
(``kv_lengths``); from 513 frames on its attention generates the mask from
those lengths and the dense [B, 1, F, F] bias is never built.

The ragged levers (``apply_frame_capacity`` and the live-prefix fold of
``SpatialTransformer``, ``stlt.py:49-71, 139-192``) take the static
capacities of the config (``configs.frame_capacity_for`` /
``spatial_live_capacity_for``, set by ``inference --live_prefix``): the
frame axis is cut to ``temporal_frame_capacity`` slots and the spatial
encoder runs on the first ``spatial_live_capacity`` live rows only. Both are
exact while every clip fits (pads are tail-contiguous, the temporal encoder
is causal, the spatial stage is row-independent); a batch that does not fit
raises.

``model.train()`` is JAX's ``deterministic=False``: the two embedding
dropouts (``stlt.py:100,232``) apply, and every encoder layer runs its train
path (``models/layers.py``): the attention through the train kernels (at
long clips the temporal attention through the long-clip kernels and their
backwards, with the same ``kv_lengths`` and ``causal`` as in eval), the tail
through the plain chain with hashed dropout or, from 256 frames on (the
spatial stage's frame axis after any frame capacity and the temporal
stage's frame count, JAX's ``clip_frames``), through
``ops/fused_tail_train``'s kernels. Both levers run under autograd:
the fold's gather and scatter carry the live rows' gradients, and cut frame
slots and dead rows get none. The random draws come, in
forward order, from the ``torch.Generator`` passed to :meth:`Stlt.forward`:
the category-box embedding mask, each spatial layer's two seeds, the frame
embedding mask, each temporal layer's two seeds. ``model.eval()`` runs the
eval kernels and draws nothing.
"""

from __future__ import annotations

import contextlib
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
    embedding_dropout,
    init_linear_,
)
from stlt_tpu_torch.ops import masks
from stlt_tpu_torch.ops.flash import _BLOCKWISE_MIN_SEQ

NUM_FRAME_TYPES = 5  # reference models.py:91

# Per-frame streams of a layout batch: the keys apply_frame_capacity cuts.
_PER_FRAME_KEYS = ("categories", "boxes", "scores", "frame_types")


def apply_frame_capacity(cfg: StltModelConfig, batch: Dict[str, torch.Tensor]):
    """Cut the layout frame axis to ``cfg.temporal_frame_capacity`` slots.
    Pads are tail-contiguous, so the cut drops only pad slots while every
    clip's live frames fit; the temporal encoder is causal and pooling reads
    ``lengths - 1 < cap``, so the logits are those of the whole axis."""
    cap = cfg.temporal_frame_capacity
    num_frames = batch["frame_types"].shape[1]
    if cap is None or cap >= num_frames:
        return batch
    if bool((batch["frame_types"][:, cap:] != 0).any()):
        raise ValueError(f"temporal_frame_capacity {cap} cuts live frames of this batch")
    out = dict(batch)
    for key in _PER_FRAME_KEYS:
        if key in out:
            out[key] = out[key][:, :cap]
    return out


def backbone_frozen(cfg) -> bool:
    """Whether a model's ``backbone`` was loaded and frozen
    (``load_backbone_path`` with ``freeze_backbone``): JAX then runs it
    deterministically in training (``stlt_tpu/models/stlt.py:329-336``,
    ``fusion.py:286-294``), and the optimizer leaves it out."""
    return bool(cfg.load_backbone_path and cfg.freeze_backbone)


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


def _encoder(cfg: StltModelConfig, num_layers: int, generator, causal: bool = False) -> TransformerEncoder:
    return TransformerEncoder(
        num_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.hidden_size * 4,
        activation="gelu", layer_norm_eps=cfg.layer_norm_eps, dtype=_dtype(cfg),
        generator=generator, dropout_rate=cfg.hidden_dropout_prob, causal=causal,
    )


class CategoryBoxEmbeddings(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype = _dtype(cfg)
        self.eps = cfg.layer_norm_eps
        self.dropout_rate = cfg.hidden_dropout_prob
        self.category_embeddings = _embedding(cfg.unique_categories, cfg.hidden_size, generator, 0)
        self.box_embedding = nn.Linear(4, cfg.hidden_size)
        self.score_embeddings = nn.Linear(1, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        init_linear_(self.box_embedding, generator)
        init_linear_(self.score_embeddings, generator)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        dt = self.dtype
        emb = nn.functional.embedding(batch["categories"], self.category_embeddings.weight.to(dt))
        emb = emb + apply_dense(batch["boxes"], self.box_embedding, dt)
        if "scores" in batch:
            # Only Action Genome batches carry detector scores.
            emb = emb + apply_dense(batch["scores"][..., None], self.score_embeddings, dt)
        emb = apply_layer_norm(emb, self.layer_norm.weight, self.layer_norm.bias, self.eps, dt)
        return embedding_dropout(emb, self.dropout_rate, generator) if self.training else emb


class SpatialTransformer(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.category_box_embeddings = CategoryBoxEmbeddings(cfg, generator)
        # The reference keeps its prototype layer as an attribute; its
        # parameters are in every checkpoint and never run.
        self.encoder_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.hidden_size * 4,
            activation="gelu", layer_norm_eps=cfg.layer_norm_eps, dtype=_dtype(cfg),
            generator=generator,
        )
        self.transformer = _encoder(cfg, cfg.num_spatial_layers, generator)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        tokens = self.category_box_embeddings(batch, generator)  # [B, F, O, H]
        B, F, O, H = tokens.shape
        pad_bias = masks.key_padding_bias(
            masks.boxes_padding_mask(batch["categories"]).reshape(B * F, O)
        )
        # Pad-frame compaction: rows of pad frames are dead downstream.
        rows_live = (batch["frame_types"] != 0).reshape(B * F)
        tokens = tokens.reshape(B * F, O, H)
        cap = self.config.spatial_live_capacity
        if cap is not None and cap < B * F:
            # Live-prefix fold: live rows first (a stable sort of the dead
            # flags), the encoder on the first `cap` rows only, the frame-CLS
            # vectors scattered back into zeros (dead rows are zeros anyway).
            if int(rows_live.sum()) > cap:
                raise ValueError(f"spatial_live_capacity {cap} is below this batch's "
                                 f"{int(rows_live.sum())} live frame rows")
            idx = torch.argsort((~rows_live).to(torch.int32), stable=True)[:cap]
            compact = self.transformer(tokens.index_select(0, idx), pad_bias.index_select(0, idx),
                                       rows_live=rows_live.index_select(0, idx), generator=generator,
                                       clip_frames=F)
            cls = torch.zeros((B * F, H), dtype=compact.dtype, device=compact.device)
            return cls.index_copy(0, idx, compact[:, 0, :]).reshape(B, F, H)
        tokens = self.transformer(tokens, pad_bias, rows_live=rows_live, generator=generator,
                                  clip_frames=F)
        return tokens[:, 0, :].reshape(B, F, H)  # the frame-CLS token


class FramesEmbeddings(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype = _dtype(cfg)
        self.eps = cfg.layer_norm_eps
        self.dropout_rate = cfg.hidden_dropout_prob
        self.layout_num_frames = cfg.layout_num_frames
        self.layout_embedding = SpatialTransformer(cfg, generator)
        self.position_embeddings = _embedding(cfg.layout_num_frames, cfg.hidden_size, generator)
        self.frame_type_embedding = _embedding(NUM_FRAME_TYPES, cfg.hidden_size, generator, 0)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.register_buffer(
            "position_ids", torch.arange(cfg.layout_num_frames).expand((1, -1))
        )

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        dt = self.dtype
        frames = self.layout_embedding(batch, generator)
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
        emb = apply_layer_norm(emb, self.layer_norm.weight, self.layer_norm.bias, self.eps, dt)
        return embedding_dropout(emb, self.dropout_rate, generator) if self.training else emb


class StltBackbone(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.frames_embeddings = FramesEmbeddings(cfg, generator)
        self.transformer = _encoder(cfg, cfg.num_temporal_layers, generator, causal=True)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        batch = apply_frame_capacity(self.config, batch)
        emb = self.frames_embeddings(batch, generator)
        num_frames = emb.shape[1]
        tokens_live = batch["frame_types"] != 0
        kv_lengths = tokens_live.sum(dim=1, dtype=torch.int32)
        bias = None  # from 513 frames on the attention masks from kv_lengths
        if num_frames < _BLOCKWISE_MIN_SEQ:
            bias = masks.causal_bias(num_frames, emb.device) + masks.key_padding_bias(
                masks.frames_padding_mask(batch["frame_types"])
            )
        return self.transformer(emb, bias, tokens_live=tokens_live, generator=generator,
                                kv_lengths=kv_lengths, clip_frames=num_frames)  # [B, F, H]


class ClassificationHead(nn.Module):
    """fc1 -> GELU -> LayerNorm -> fc2 (reference models.py:155-163; with
    ``in_features`` 2H the fusion models' ``FusionHead``, models.py:286-294)."""

    def __init__(self, hidden_size: int, num_classes: int, layer_norm_eps: float,
                 dtype: torch.dtype, generator: torch.Generator, in_features: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.eps = layer_norm_eps
        self.fc1 = nn.Linear(in_features or hidden_size, hidden_size)
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

    def train(self, mode: bool = True):
        """A loaded and frozen backbone stays in eval mode: it runs the eval
        kernels under ``torch.no_grad`` and only the head trains."""
        super().train(mode)
        if mode and backbone_frozen(self.config):
            self.backbone.eval()
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Logits {"stlt": [B, C] f32}. In train mode with dropout,
        ``generator`` (a CPU ``torch.Generator``) supplies every random draw."""
        frozen = self.training and backbone_frozen(self.config)
        with torch.no_grad() if frozen else contextlib.nullcontext():
            hidden = self.backbone(batch, generator)
        pooled = gather_extract_frame(hidden, batch["lengths"])
        return {"stlt": self.prediction_head(pooled).to(torch.float32)}
