"""Multimodal fusion models, eval: LCF, CAF and CACNF.

Port of ``stlt_tpu/models/fusion.py`` (reference ``src/modelling/models.py:
286-549``): ``FusionHead`` (:40), ``FeedforwardModule`` (:56),
``SelfAttentionLayer`` (:72), ``CrossAttentionLayer`` (:100),
``CrossModalModule`` (:129), ``LateConcatenationFusion`` (:176),
``CrossAttentionFusionBackbone`` (:203), ``CrossAttentionFusion`` (:259) and
``CrossAttentionCentralNetFusion`` (:277). The reference's quirks stay, as
the released checkpoints hold them:

- ``CrossModalModule`` runs ONE shared ``cross_attn`` in both directions
  (layout <- appearance, then appearance <- layout), with the layout padding
  bias only in the second direction;
- ``appearance_ffn`` is a ``SelfAttentionLayer``, not a feed-forward module;
- the fusion masks come from the layout frame axis after the frame-capacity
  cut (``apply_frame_capacity``), the same axis the layout branch returns;
- CACNF's ``ensemble`` is the mean of its three f32 logits.

Each attention goes through ``models/layers.MultiHeadAttention``: the self-
and cross-attentions of up to 64 tokens through the fused kernels
(``fused_proj_attention``, ``fused_cross_attention``), longer ones through
the attention core with the dense bias (at 512 layout frames, 513 tokens:
the blockwise kernel in dense-bias mode, ``causal=False`` as in JAX: the
causal+padding bias masks). The sublayers' dropout, LayerNorm and FFN are
plain torch, as JAX runs them in XLA. Module and logit names are the
reference's. Eval only: fusion training waits for ``ROADMAP.md`` item A8
(train).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from stlt_tpu_torch.configs import MultimodalModelConfig
from stlt_tpu_torch.models.appearance import TransformerResnet, refuse_train
from stlt_tpu_torch.models.layers import (
    MultiHeadAttention,
    activation_fn,
    apply_dense,
    apply_layer_norm,
    init_linear_,
)
from stlt_tpu_torch.models.stlt import (
    ClassificationHead,
    StltBackbone,
    _dtype,
    apply_frame_capacity,
    gather_extract_frame,
)
from stlt_tpu_torch.ops import masks

_TRAIN_ITEM = "A8 (train)"


def FusionHead(cfg: MultimodalModelConfig, generator: torch.Generator) -> ClassificationHead:
    """Linear(2H -> H) -> GELU -> LayerNorm -> Linear(H -> C)."""
    return ClassificationHead(cfg.hidden_size, cfg.num_classes, cfg.layer_norm_eps, _dtype(cfg),
                              generator, in_features=2 * cfg.hidden_size)


class FeedforwardModule(nn.Module):
    """Post-LN residual FFN: ``ln(x + linear2(gelu(linear1(x))))``."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype, self.eps = _dtype(cfg), cfg.layer_norm_eps
        self.linear1 = nn.Linear(cfg.hidden_size, 4 * cfg.hidden_size)
        self.linear2 = nn.Linear(4 * cfg.hidden_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        init_linear_(self.linear1, generator)
        init_linear_(self.linear2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = activation_fn("gelu", dt)(apply_dense(x, self.linear1, dt))
        h = apply_dense(h, self.linear2, dt)
        return apply_layer_norm(h + x, self.ln.weight, self.ln.bias, self.eps, dt)


class _AttentionLayer(nn.Module):
    """Post-LN residual attention: ``ln(x + attn(x, context))``."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.dtype, self.eps = _dtype(cfg), cfg.layer_norm_eps
        self.attn = MultiHeadAttention(cfg.hidden_size, cfg.num_attention_heads, self.dtype,
                                       generator, cfg.hidden_dropout_prob)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def _residual(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return apply_layer_norm(h + x, self.ln.weight, self.ln.bias, self.eps, self.dtype)


class SelfAttentionLayer(_AttentionLayer):
    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._residual(x, self.attn(x, bias))


class CrossAttentionLayer(_AttentionLayer):
    def forward(self, inputs: torch.Tensor, context: torch.Tensor,
                context_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._residual(inputs, self.attn(inputs, context_bias, context=context))


class CrossModalModule(nn.Module):
    """One fusion block."""

    def __init__(self, cfg: MultimodalModelConfig, generator: torch.Generator):
        super().__init__()
        self.cross_attn = CrossAttentionLayer(cfg, generator)  # shared, both directions
        self.layout_attn = SelfAttentionLayer(cfg, generator)
        self.layout_ffn = FeedforwardModule(cfg, generator)
        self.appearance_attn = SelfAttentionLayer(cfg, generator)
        self.appearance_ffn = SelfAttentionLayer(cfg, generator)  # the reference's quirk

    def forward(self, layout_hidden, appearance_hidden, layout_causal_pad_bias, layout_pad_bias):
        layout_out = self.cross_attn(layout_hidden, appearance_hidden)
        appearance_out = self.cross_attn(appearance_hidden, layout_hidden, layout_pad_bias)
        layout_out = self.layout_attn(layout_out, layout_causal_pad_bias)
        appearance_out = self.appearance_attn(appearance_out)
        layout_out = self.layout_ffn(layout_out)
        appearance_out = self.appearance_ffn(appearance_out)
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
        refuse_train(self, _TRAIN_ITEM)
        layout = gather_extract_frame(self.layout_branch(batch), batch["lengths"])
        appearance = self.appearance_branch.forward_features(batch)[:, 0, :]
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

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # The layout branch returns the frame axis after the capacity cut, so
        # the fusion masks come from the same cut axis.
        frame_types = apply_frame_capacity(self.config.stlt_config, batch)["frame_types"]
        layout_pad_bias = masks.key_padding_bias(masks.frames_padding_mask(frame_types))
        layout_causal_pad_bias = (masks.causal_bias(frame_types.shape[1], frame_types.device)
                                  + layout_pad_bias)

        layout_hidden = self.layout_branch(batch)
        appearance_hidden = self.appearance_branch.forward_features(batch)
        layout_state = gather_extract_frame(layout_hidden, batch["lengths"])
        appearance_state = appearance_hidden[:, 0, :]
        for layer in self.mm_fusion:
            layout_hidden, appearance_hidden = layer(
                layout_hidden, appearance_hidden, layout_causal_pad_bias, layout_pad_bias)
        last_fused_state = torch.cat(
            [gather_extract_frame(layout_hidden, batch["lengths"]), appearance_hidden[:, 0, :]],
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
        refuse_train(self, _TRAIN_ITEM)
        states = self.caf_backbone(batch)
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

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        refuse_train(self, _TRAIN_ITEM)
        states = self.backbone(batch)
        f32 = torch.float32
        stlt = self.layout_classifier(states["layout_hidden_state"]).to(f32)
        resnet = self.appearance_classifier(states["appearance_hidden_state"]).to(f32)
        caf = self.fusion_classifier(states["last_fused_state"]).to(f32)
        return {"stlt": stlt, "resnet3d": resnet, "caf": caf,
                "ensemble": (stlt + resnet + caf) / 3.0}
