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

Under a context mesh (``--context_parallel C``, ``parallel/mesh.py``) the
backbone runs frame-sharded, as JAX's GSPMD layout shards it
(``stlt_tpu/training/loop.py:24-48``): each rank keeps its ``F / C`` frames
from the embedding to the last temporal layer (the frame positions
``rank t .. rank t + t - 1``; ``kv_lengths`` and the live tokens from the
whole clip), the temporal attention is ring attention (``ops/ring.py``),
and the extract frame ``lengths - 1``, held by one rank, reaches every rank
by a sum over the ring in which the others add zeros; every rank then runs
the head. The ragged levers stay off there (``stlt_tpu/models/stlt.py:61-62,
154``). In training the gradients flow back the same way: the sum passes
its cotangent to the holder only, the ring attention's backward runs the
ring again, and each rank's backbone gradients are its part of the whole,
which the train step sums over the ring (``training/loop.py``).

Under a data axis (``--num_processes N``, ``parallel/mesh.py``) each rank
runs the whole model on its clips of the global batch, and under both (a
grid of D rings of C ranks) each ring its clips. Every dropout site off the
ring hashes or draws its bits at the global coordinates, as JAX's GSPMD
step does on the global arrays: the spatial encoder's (clip, frame) rows
and the temporal encoder's tail tokens at ``parallel/mesh.frame_rows``
((clip0 + b) F + f0 + j: the affine ``clip0 F + i`` without a ring, period
t and stride F on a ring rank), the temporal attention off the ring at the
clips from ``clip0``, the embedding masks as the rank's clips and frames
of the global batch's (``clip_span``, ``frame_span``). So the ranks drop
what one process drops on the whole batch; the ring attention hashes with
the ring's own seeds (``ops/ring.py``).
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
    column_input,
    embedding_dropout,
    gather_columns,
    init_linear_,
)
from stlt_tpu_torch.ops import masks
from stlt_tpu_torch.ops.flash import _BLOCKWISE_MIN_SEQ
from stlt_tpu_torch.ops.ring import context_sum
from stlt_tpu_torch.parallel.mesh import (Mesh, active_context_mesh, active_model_mesh, clip_span,
                                          frame_rows, frame_span)
from stlt_tpu_torch.training.loop import shard_frames

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


def embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of a small ``table`` (the category and frame-type
    tables: 4 and 5 rows) as a one-hot product. Each output sums one
    product, 1 x the row, so the values are the gather's bit for bit; the
    table's gradient is one matmul over the ids, which repeats its bits on
    the card. The CUDA backward of ``nn.functional.embedding`` does not for
    tables this small: on the same gradient and ids, repeated calls give
    other bits in f32, and now and then in bf16
    (``chip_smoke.py::check_embedding_backward``)."""
    one_hot = ids[..., None] == torch.arange(table.shape[0], device=ids.device)
    return one_hot.to(table.dtype) @ table


def _encoder(cfg: StltModelConfig, num_layers: int, generator, causal: bool = False,
             seq_shard: bool = False) -> TransformerEncoder:
    return TransformerEncoder(
        num_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.hidden_size * 4,
        activation="gelu", layer_norm_eps=cfg.layer_norm_eps, dtype=_dtype(cfg),
        generator=generator, dropout_rate=cfg.hidden_dropout_prob, causal=causal,
        seq_shard=seq_shard, remat=cfg.remat,
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
        emb = embed(batch["categories"], self.category_embeddings.weight.to(dt))
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
        # The tail's gate takes the whole frame axis under a ring, as JAX's
        # sees the global array.
        tokens = self.transformer(tokens, pad_bias, rows_live=rows_live, generator=generator,
                                  clip_frames=frame_span(F)[1], row0=frame_rows(B, F))
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

    def forward(self, batch: Dict[str, torch.Tensor], generator=None,
                position_offset: int = 0, total_frames: int = 0) -> torch.Tensor:
        """``position_offset``: the global index of the batch's first frame
        (a context rank's slice); ``total_frames``: the whole (padded) frame
        axis the position table must hold (default: the batch's own)."""
        dt = self.dtype
        frames = self.layout_embedding(batch, generator)
        num_frames = frames.shape[1]
        total = max(total_frames, position_offset + num_frames)
        if total > self.layout_num_frames:
            raise ValueError(
                f"clip has {total} frames but the position table holds "
                f"{self.layout_num_frames}; size the model config with "
                f"configs.position_table_rows(data_config)"
            )
        positions = self.position_embeddings.weight[None, position_offset:position_offset + num_frames].to(dt)
        types = embed(batch["frame_types"], self.frame_type_embedding.weight.to(dt))
        emb = frames + positions + types
        emb = apply_layer_norm(emb, self.layer_norm.weight, self.layer_norm.bias, self.eps, dt)
        return embedding_dropout(emb, self.dropout_rate, generator) if self.training else emb


class StltBackbone(nn.Module):
    def __init__(self, cfg: StltModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.frames_embeddings = FramesEmbeddings(cfg, generator)
        # Its token axis is the frame axis: ring attention under a context mesh.
        self.transformer = _encoder(cfg, cfg.num_temporal_layers, generator, causal=True,
                                    seq_shard=True)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> torch.Tensor:
        """[B, F, H]; under a context mesh this rank's [B, F / C, H]."""
        ring = active_context_mesh()
        if ring is not None:
            return self._sharded(batch, generator, ring)
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
                                kv_lengths=kv_lengths, clip_frames=num_frames,
                                row0=clip_span(emb.shape[0])[0])  # [B, F, H]

    def _sharded(self, batch, generator, ring) -> torch.Tensor:
        """This context rank's frames through the backbone: the live tokens
        and ``kv_lengths`` from the whole clip, the ring's lengths mode (no
        dense bias) in every temporal layer."""
        cfg = self.config
        if cfg.temporal_frame_capacity is not None or cfg.spatial_live_capacity is not None:
            raise ValueError("the ragged levers (frame and live-row capacities) stay off under "
                             "a context mesh: the ring shards the frame axis")
        num_frames = batch["frame_types"].shape[1]
        tokens_live = batch["frame_types"] != 0
        kv_lengths = tokens_live.sum(dim=1, dtype=torch.int32)
        local, offset = shard_frames(batch, ring.context_size, ring.context_index)
        emb = self.frames_embeddings(local, generator, position_offset=offset,
                                     total_frames=num_frames)
        live = tokens_live[:, offset:offset + emb.shape[1]]
        return self.transformer(emb, None, tokens_live=live, generator=generator,
                                kv_lengths=kv_lengths, clip_frames=num_frames,
                                token0=frame_rows(emb.shape[0], emb.shape[1]))


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
        """Under a model mesh ``fc1`` is column-sharded: its input enters
        through ``layers.column_input``, its columns are gathered from the
        model ranks before the GELU and the LayerNorm (the backward takes
        the rank's columns), and ``fc2`` runs replicated."""
        model = active_model_mesh()
        h = gather_columns(apply_dense(column_input(hidden_state, model), self.fc1, self.dtype), model)
        h = activation_fn("gelu", self.dtype)(h)
        h = apply_layer_norm(h, self.layer_norm.weight, self.layer_norm.bias, self.eps, self.dtype)
        return apply_dense(h, self.fc2, self.dtype)


def gather_extract_frame(hidden_states: torch.Tensor, lengths: torch.Tensor,
                         ring: Optional[Mesh]) -> torch.Tensor:
    """The hidden state at frame ``lengths - 1``, the appended EXTRACT frame.
    [B, F, H] -> [B, H]. ``ring``: the context mesh whose ranks each hold
    their frames of ``hidden_states`` (a frame-sharded backbone's output):
    the rank that holds a clip's extract frame gives its row, the others
    zeros, summed over the ring (its group); None: ``hidden_states`` holds
    the whole frame axis (no ring, or a stream gathered from it, as the
    fusion blocks' layout stream), read at the frame itself."""
    rows = torch.arange(hidden_states.shape[0], device=hidden_states.device)
    if ring is None:
        return hidden_states[rows, lengths.long() - 1]
    t = hidden_states.shape[1]
    local = lengths.long() - 1 - ring.context_index * t
    held = (local >= 0) & (local < t)
    mine = hidden_states[rows, local.clamp(0, t - 1)]
    mine = torch.where(held[:, None], mine, torch.zeros((), dtype=mine.dtype, device=mine.device))
    return context_sum(mine, ring)


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
        pooled = gather_extract_frame(hidden, batch["lengths"], active_context_mesh())
        return {"stlt": self.prediction_head(pooled).to(torch.float32)}
