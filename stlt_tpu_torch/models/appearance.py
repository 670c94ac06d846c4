"""Appearance branch, eval and train: frozen-BN R3D features and a
transformer head.

Port of ``stlt_tpu/models/appearance.py`` (reference
``src/modelling/models.py:198-283``):

- ``Resnet3D`` (:45): the R3D trunk (``models/resnet3d.py``) with avgpool
  and a linear classifier when called on its own (``"resnet3d"``);
- ``TransformerResnet`` (:96): R3D features -> 1x1x1 Conv3d projector ->
  spatio-temporal tokens (T-major, torch's ``flatten(2)``) -> a learned CLS
  token and ``pos_embed`` [S + 1, 1, H] -> a ``TransformerEncoder`` with the
  torch defaults the reference keeps here (ReLU, dropout 0.1, LayerNorm eps
  1e-5) -> classifier on CLS (``"resnet3d-transformer"``).

Frames arrive as the JAX package has them, channel-last ``[B, T, H, W, 3]``
f32 (or uint8 with ``--device_normalize``, normalised here with the host
pipeline's constants and op order), and are permuted to channel-first once.
The module names are the reference's torch ones, including its dead
classifiers: ``TransformerResnet.resnet.classifier`` is the reference's
hardcoded ``Linear(2048, C)`` and, inside the fusion models,
``TransformerResnet.classifier`` never runs either; both are in every
checkpoint.

The encoder runs on the card as every encoder of the port does (T = S + 1 =
33 at 32 frames of 112 px): in eval two fused ops a layer, the layer tail
with the ReLU activation (code 0); in train (``model.train()``, JAX's
``deterministic=False``) the attention through ``fused_proj_attention_train``
(its forward and backward kernels, hashed probability dropout) and the plain
train tail with hashed dropout, since JAX passes this encoder no
``clip_frames`` (``stlt_tpu/models/appearance.py:115-126``). Each layer's
two dropout seeds come from the ``torch.Generator`` given to ``forward``,
in forward order, as the STLT layers draw theirs, and hash at the global
clips under a data axis (``parallel/mesh.clip_span``). The R3D trunk has no
dropout and its ``FrozenBatchNorm`` stays an affine map of frozen
statistics in train mode; its convolutions and their backwards run on
cuDNN, as JAX leaves them to XLA. ``TransformerResnet.no_weight_decay``
names ``pos_embed`` and ``cls_token`` for the optimizer, as JAX's does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from stlt_tpu_torch.configs import AppearanceModelConfig
from stlt_tpu_torch.data.transforms import NORM_DIVISOR, NORM_OFFSET
from stlt_tpu_torch.models import resnet3d
from stlt_tpu_torch.models.layers import TransformerEncoder, apply_dense, init_linear_, uniform_
from stlt_tpu_torch.parallel.mesh import clip_span

# torch.nn.TransformerEncoderLayer defaults (the reference passes none of
# them for the appearance encoder).
TORCH_ENCODER_DROPOUT = 0.1
TORCH_ENCODER_ACTIVATION = "relu"
TORCH_ENCODER_LN_EPS = 1e-5
# The reference's Resnet3D hardcodes Linear(2048, C) (models.py:212).
REFERENCE_CLASSIFIER_FEATURES = 2048


def _dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]


class Resnet3D(nn.Module):
    """R3D feature extractor, plus avgpool and a classifier when called.
    ``classifier_features`` sizes the classifier's input (the trunk's
    channels by default)."""

    logit_names = ("resnet3d",)

    def __init__(self, config: AppearanceModelConfig, generator: Optional[torch.Generator] = None,
                 classifier_features: Optional[int] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.dtype = _dtype(config)
        self.resnet = resnet3d.r3d_trunk(config.resnet_depth, generator)
        self.classifier = nn.Linear(classifier_features or resnet3d.out_features(config.resnet_depth),
                                    config.num_classes)
        init_linear_(self.classifier, generator)

    def forward_features(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, T, H, W, 3] frames -> [B, C, T', H', W'] features."""
        frames = batch["video_frames"]
        if frames.dtype == torch.uint8:
            frames = frames.to(torch.float32) / NORM_DIVISOR + NORM_OFFSET
        return self.resnet(frames.permute(0, 4, 1, 2, 3).to(self.dtype))

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        pooled = self.forward_features(batch).mean(dim=(2, 3, 4))  # AdaptiveAvgPool3d(1)
        return {"resnet3d": apply_dense(pooled, self.classifier, self.dtype).to(torch.float32)}


class TransformerResnet(nn.Module):
    logit_names = ("resnet3d",)

    def __init__(self, config: AppearanceModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.dtype = _dtype(config)
        H = config.hidden_size
        self.resnet = Resnet3D(config, generator, REFERENCE_CLASSIFIER_FEATURES)
        features = resnet3d.out_features(config.resnet_depth)
        self.projector = nn.Conv3d(features, H, 1)
        uniform_(self.projector.weight, 1.0 / math.sqrt(features), generator)
        uniform_(self.projector.bias, 1.0 / math.sqrt(features), generator)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, H))
        self.pos_embed = nn.Parameter(torch.zeros(config.appearance_num_frames + 1, 1, H))
        self.transformer = TransformerEncoder(
            config.num_appearance_layers, H, config.num_attention_heads, 4 * H,
            activation=TORCH_ENCODER_ACTIVATION, layer_norm_eps=TORCH_ENCODER_LN_EPS,
            dtype=self.dtype, generator=generator, dropout_rate=TORCH_ENCODER_DROPOUT,
            remat=config.remat,
        )
        self.classifier = nn.Linear(H, config.num_classes)
        init_linear_(self.classifier, generator)

    @staticmethod
    def no_weight_decay():
        return {"pos_embed", "cls_token"}

    def forward_features(self, batch: Dict[str, torch.Tensor],
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, S + 1, H]: the encoded CLS and appearance tokens; in train
        mode with dropout the encoder's seeds come from ``generator``."""
        cfg, dt = self.config, self.dtype
        feats = self.resnet.forward_features(batch)
        # The 1x1x1 projector, its bias added in the compute dtype as flax's
        # nn.Conv adds it.
        feats = F.conv3d(feats, self.projector.weight.to(dt)) + self.projector.bias.to(dt).view(1, -1, 1, 1, 1)
        tokens = feats.flatten(2).transpose(1, 2)  # [B, S, H], T-major
        B, S, H = tokens.shape
        if S != cfg.appearance_num_frames:
            raise ValueError(
                f"R3D emitted {S} tokens but the pos_embed table holds "
                f"appearance_num_frames={cfg.appearance_num_frames}; they must match "
                "(e.g. 32 frames @112px -> 2*4*4 = 32 tokens). Adjust "
                "--appearance_num_frames or --spatial_size."
            )
        tokens = torch.cat([self.cls_token.to(dt).expand(B, 1, H), tokens], dim=1)
        tokens = tokens + self.pos_embed[:, 0, :][None].to(dt)
        return self.transformer(tokens, generator=generator, row0=clip_span(B)[0])

    def forward(self, batch: Dict[str, torch.Tensor], generator=None) -> Dict[str, torch.Tensor]:
        cls_state = self.forward_features(batch, generator)[:, 0, :]
        return {"resnet3d": apply_dense(cls_state, self.classifier, self.dtype).to(torch.float32)}
