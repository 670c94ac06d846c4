"""Multimodal fusion models, eval and train: LCF, CAF and CACNF.

Port of ``stlt_tpu/models/fusion.py`` (reference ``src/modelling/models.py:
286-549``): ``FusionHead`` (:40), ``FeedforwardModule`` (:56),
``SelfAttentionLayer`` (:72), ``CrossAttentionLayer`` (:100),
``CrossModalModule`` (:129), ``LateConcatenationFusion`` (:176),
``CrossAttentionFusionBackbone`` (:203), ``CrossAttentionFusion`` (:259) and
``CrossAttentionCentralNetFusion`` (:277). The reference's quirks stay, as
the released checkpoints hold them:

- ``CrossModalModule`` runs ONE shared ``cross_attn`` in both directions
  (layout <- appearance, then appearance <- layout), with the layout padding
  bias only in the second direction; in training each call draws its own
  seeds and autograd sums the two uses' gradients;
- ``appearance_ffn`` is a ``SelfAttentionLayer``, not a feed-forward module;
- the fusion masks come from the layout frame axis after the frame-capacity
  cut (``apply_frame_capacity``), the same axis the layout branch returns;
- CACNF's ``ensemble`` is the mean of its three f32 logits.

Each attention goes through ``models/layers.MultiHeadAttention``: in eval
the self- and cross-attentions of up to 64 tokens through the fused kernels
(``fused_proj_attention``, ``fused_cross_attention``); in train the
self-attentions of up to 64 tokens through ``fused_proj_attention_train``
and the cross-attentions below 513 tokens through the short flash kernel and
its backward; longer ones (at 512 layout frames, 513 tokens) through the
attention core with the dense bias: the blockwise kernel in dense-bias mode,
forward and backward, ``causal=False`` as in JAX (the causal+padding bias
masks). The sublayers' LayerNorm and FFN are plain torch, as JAX runs them
in XLA.

Train mode (``model.train()``, JAX's ``deterministic=False``). JAX drops
each sublayer's output (after each attention and each FFN, ``fusion.py:68,
95, 123``) with flax ``nn.Dropout``, whose stream the port cannot
reproduce; the port hashes its own keep bits on the device
(``ops/dropout.hashed_dropout``) from a seed drawn from the step's
``torch.Generator``: deterministic for a given (``--seed``, step), the same
distribution as JAX's, hashed at the global clips under a data axis
(``parallel/mesh.clip_span``), as every site of the layout branch. Every
random draw comes from that generator in forward order: the layout
branch's (as ``Stlt`` draws them), the appearance encoder's, then per
fusion layer and sublayer the attention's seed and the output dropout's. A loaded and frozen CACNF backbone (``load_backbone_path``
with ``freeze_backbone``) runs deterministically, as JAX runs it
(``fusion.py:286-294``): ``model.train()`` leaves it in eval mode, so it
takes the eval kernels under ``torch.no_grad`` and only the three heads
train. Module and logit names are the reference's.

Under a context mesh (``--context_parallel C``, ``parallel/mesh.py``) the
layout branch (a ``StltBackbone``) runs frame-sharded on the ring, as
STLT's backbone does: each rank its ``F / C`` frames, the temporal
attention a ring. LCF reads its extract frame as STLT's head does, by a sum
over the ring. CAF and CACNF gather the branch's frames over the ring
(``ops/ring.gather_frames``) into the whole ``[B, F, H]`` axis, and every
ring rank runs the appearance branch, the fusion blocks and the heads on
the same whole tensors, as JAX's GSPMD gathers the frame axis for the
fusion attentions (``video_frames`` replicated over ``context``). The
fusion blocks are not sharded: ``CrossModalModule``'s one ``cross_attn``
serves both directions, so with sharded layout queries its weights would
take part of their gradient from one direction and all of it from the
other, which no one sum over the ring puts right. Everything after the
gather is replicated, so its dropout sites hash at the global clips as one
process's do, and the train step sums over the ring the layout branch's
gradients alone (``training/loop.ring_sharded_parameters``) and takes the
ring's rank 0's for the rest (``training/loop.sync_over_ring_``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from stlt_tpu_torch.configs import MultimodalModelConfig
from stlt_tpu_torch.models.appearance import TransformerResnet
from stlt_tpu_torch.models.layers import (
    MultiHeadAttention,
    activation_fn,
    apply_dense,
    apply_layer_norm,
    column_input,
    draw_seeds,
    init_linear_,
    row_parallel_dense,
)
from stlt_tpu_torch.models.stlt import (
    ClassificationHead,
    StltBackbone,
    _dtype,
    apply_frame_capacity,
    backbone_frozen,
    gather_extract_frame,
)
from stlt_tpu_torch.ops import masks
from stlt_tpu_torch.ops.dropout import TAG_OUT_DROP, hashed_dropout
from stlt_tpu_torch.ops.ring import gather_frames
from stlt_tpu_torch.parallel.mesh import active_context_mesh, active_model_mesh, clip_span


def FusionHead(cfg: MultimodalModelConfig, generator: torch.Generator) -> ClassificationHead:
    """Linear(2H -> H) -> GELU -> LayerNorm -> Linear(H -> C)."""
    return ClassificationHead(cfg.hidden_size, cfg.num_classes, cfg.layer_norm_eps, _dtype(cfg),
                              generator, in_features=2 * cfg.hidden_size)


def _output_dropout(module: nn.Module, h: torch.Tensor, generator) -> torch.Tensor:
    """A sublayer's output dropout in train mode (flax ``nn.Dropout`` in
    JAX): hashed keep bits from one seed of ``generator``, at the global
    tokens of h's clips (``parallel/mesh.clip_span``)."""
    rate = module.dropout_rate
    if not module.training or rate <= 0.0:
        return h
    (seed,) = draw_seeds(generator, 1)
    return hashed_dropout(h, seed, TAG_OUT_DROP, rate, clip_span(h.shape[0])[0] * h.shape[1])


class FeedforwardModule(nn.Module):
    """Post-LN residual FFN: ``ln(x + drop(linear2(gelu(linear1(x)))))``."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype, self.eps = _dtype(cfg), cfg.layer_norm_eps
        self.dropout_rate = cfg.hidden_dropout_prob
        self.linear1 = nn.Linear(cfg.hidden_size, 4 * cfg.hidden_size)
        self.linear2 = nn.Linear(4 * cfg.hidden_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        init_linear_(self.linear1, generator)
        init_linear_(self.linear2, generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dt, model = self.dtype, active_model_mesh()  # linear1 / linear2 column / row-sharded there
        h = activation_fn("gelu", dt)(apply_dense(column_input(x, model), self.linear1, dt))
        h = row_parallel_dense(h, self.linear2, dt, model)
        h = _output_dropout(self, h, generator)
        return apply_layer_norm(h + x, self.ln.weight, self.ln.bias, self.eps, dt)


class _AttentionLayer(nn.Module):
    """Post-LN residual attention: ``ln(x + drop(attn(x, context)))``; in
    train mode with dropout the attention's seed, then the output
    dropout's, from ``generator``."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype, self.eps = _dtype(cfg), cfg.layer_norm_eps
        self.dropout_rate = cfg.hidden_dropout_prob
        self.attn = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads, self.dtype,
                                       generator, cfg.hidden_dropout_prob)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def _attend(self, x, bias, context, generator) -> torch.Tensor:
        seed = None
        if self.training and self.dropout_rate > 0.0:
            (seed,) = draw_seeds(generator, 1)
        h = self.attn(x, bias, seed=seed, context=context, row0=clip_span(x.shape[0])[0])
        h = _output_dropout(self, h, generator)
        return apply_layer_norm(h + x, self.ln.weight, self.ln.bias, self.eps, self.dtype)


class SelfAttentionLayer(_AttentionLayer):
    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        return self._attend(x, bias, None, generator)


class CrossAttentionLayer(_AttentionLayer):
    def forward(self, inputs: torch.Tensor, context: torch.Tensor,
                context_bias: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        return self._attend(inputs, context_bias, context, generator)


class CrossModalModule(nn.Module):
    """One fusion block."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.cross_attn = CrossAttentionLayer(cfg, generator)  # shared, both directions
        self.layout_attn = SelfAttentionLayer(cfg, generator)
        self.layout_ffn = FeedforwardModule(cfg, generator)
        self.appearance_attn = SelfAttentionLayer(cfg, generator)
        self.appearance_ffn = SelfAttentionLayer(cfg, generator)  # the reference's quirk

    def forward(self, layout_hidden, appearance_hidden, layout_causal_pad_bias, layout_pad_bias,
                generator=None):
        g = generator
        layout_out = self.cross_attn(layout_hidden, appearance_hidden, generator=g)
        appearance_out = self.cross_attn(appearance_hidden, layout_hidden, layout_pad_bias, generator=g)
        layout_out = self.layout_attn(layout_out, layout_causal_pad_bias, generator=g)
        appearance_out = self.appearance_attn(appearance_out, generator=g)
        layout_out = self.layout_ffn(layout_out, generator=g)
        appearance_out = self.appearance_ffn(appearance_out, generator=g)
        return layout_out, appearance_out


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


class LateConcatenationFusion(nn.Module):
    """LCF: the two branches' pooled states concatenated into a FusionHead."""

    logit_names = ("lcf",)

    def __init__(self, config: MultimodalModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = _generator(generator)
        self.config = config
        self.layout_branch = StltBackbone(config.stlt_config, generator)
        self.appearance_branch = TransformerResnet(config.appearance_config, generator)
        self.classifier = FusionHead(config, generator)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        layout = gather_extract_frame(self.layout_branch(batch, generator), batch["lengths"],
                                      active_context_mesh())
        appearance = self.appearance_branch.forward_features(batch, generator)[:, 0, :]
        fused = torch.cat([layout, appearance], dim=-1)
        return {"lcf": self.classifier(fused).to(torch.float32)}


class CrossAttentionFusionBackbone(nn.Module):
    """The backbone of CAF and CACNF: both branches, then the fusion blocks."""

    def __init__(self, config: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        self.layout_branch = StltBackbone(config.stlt_config, generator)
        self.appearance_branch = TransformerResnet(config.appearance_config, generator)
        self.mm_fusion = nn.ModuleList(CrossModalModule(config, generator)
                                       for _ in range(config.num_fusion_layers))

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        # The layout branch returns the frame axis after the capacity cut, so
        # the fusion masks come from the same cut axis.
        frame_types = apply_frame_capacity(self.config.stlt_config, batch)["frame_types"]
        layout_pad_bias = masks.key_padding_bias(masks.frames_padding_mask(frame_types))
        layout_causal_pad_bias = (masks.causal_bias(frame_types.shape[1], frame_types.device)
                                  + layout_pad_bias)

        layout_hidden = self.layout_branch(batch, generator)
        ring = active_context_mesh()
        if ring is not None:  # this rank's frames -> the whole axis, on every ring rank
            layout_hidden = gather_frames(layout_hidden, ring)
        appearance_hidden = self.appearance_branch.forward_features(batch, generator)
        # From here on every tensor holds the whole frame axis.
        layout_state = gather_extract_frame(layout_hidden, batch["lengths"], None)
        appearance_state = appearance_hidden[:, 0, :]
        for layer in self.mm_fusion:
            layout_hidden, appearance_hidden = layer(
                layout_hidden, appearance_hidden, layout_causal_pad_bias, layout_pad_bias, generator)
        last_fused_state = torch.cat(
            [gather_extract_frame(layout_hidden, batch["lengths"], None), appearance_hidden[:, 0, :]],
            dim=-1,
        )
        return {
            "layout_hidden_state": layout_state,
            "appearance_hidden_state": appearance_state,
            "last_fused_state": last_fused_state,
        }


class CrossAttentionFusion(nn.Module):
    """CAF: the fused state into a FusionHead."""

    logit_names = ("caf",)

    def __init__(self, config: MultimodalModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = _generator(generator)
        self.config = config
        self.caf_backbone = CrossAttentionFusionBackbone(config, generator)
        self.classifier = FusionHead(config, generator)

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        states = self.caf_backbone(batch, generator)
        return {"caf": self.classifier(states["last_fused_state"]).to(torch.float32)}


class CrossAttentionCentralNetFusion(nn.Module):
    """CACNF: a head on each branch's pooled state, one on the fused state,
    and their mean."""

    logit_names = ("stlt", "resnet3d", "caf", "ensemble")

    def __init__(self, config: MultimodalModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = _generator(generator)
        self.config = config
        self.backbone = CrossAttentionFusionBackbone(config, generator)
        head = lambda: ClassificationHead(config.hidden_size, config.num_classes,  # noqa: E731
                                          config.layer_norm_eps, _dtype(config), generator)
        self.layout_classifier = head()
        self.appearance_classifier = head()
        self.fusion_classifier = FusionHead(config, generator)

    def train(self, mode: bool = True):
        """A loaded and frozen backbone stays in eval mode (see the module
        docstring)."""
        super().train(mode)
        if mode and backbone_frozen(self.config):
            self.backbone.eval()
        return self

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        frozen = self.training and backbone_frozen(self.config)
        with torch.no_grad() if frozen else contextlib.nullcontext():
            states = self.backbone(batch, generator)
        f32 = torch.float32
        stlt = self.layout_classifier(states["layout_hidden_state"]).to(f32)
        resnet = self.appearance_classifier(states["appearance_hidden_state"]).to(f32)
        caf = self.fusion_classifier(states["last_fused_state"]).to(f32)
        return {"stlt": stlt, "resnet3d": resnet, "caf": caf,
                "ensemble": (stlt + resnet + caf) / 3.0}
