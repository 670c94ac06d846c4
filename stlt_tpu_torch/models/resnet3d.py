"""3D ResNet (R3D) backbone, channel-first, eval.

Port of ``stlt_tpu/models/resnet3d.py``: R3D depths 10-200 (BasicBlock below
50, Bottleneck from 50), ``FrozenBatchNorm`` (:43) and the stem (:60). The
module tree is the reference's torch one (``src/modelling/resnets3d.py``,
wrapped in ``nn.Sequential`` by ``Resnet3D``, models.py:205), so a
reference-format state_dict loads with ``strict=True``: :func:`r3d_trunk`
returns the ``Sequential`` whose children are 0 = conv1, 1 = bn1, 2 = relu,
3 = maxpool and 4..7 = layer1..layer4, blocks named ``conv1``/``bn1``/...,
``downsample.0``/``downsample.1``.

The convolutions are ``F.conv3d`` (cuDNN on the card), as the JAX package
leaves them to XLA; no Pallas kernel runs here. ``StemConv``'s
space-to-depth regroup is a TPU layout trick that computes the same
convolution: the port runs the plain stem over the same ``[64, 3, t, 7, 7]``
parameter. Activations are channel-first ``[B, C, T, H, W]``; operands are
cast to the compute dtype as flax's ``nn.Conv(dtype=...)`` casts them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

R3D_STAGE_PLANES = (64, 128, 256, 512)
R3D_DEPTH_BLOCKS = {
    10: (1, 1, 1, 1),
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}
R3D_BOTTLENECK_DEPTHS = (50, 101, 152, 200)


def out_features(depth: int) -> int:
    """Channels of the trunk's output: 2048 with Bottleneck blocks, 512 with
    BasicBlocks."""
    return R3D_STAGE_PLANES[-1] * (4 if depth in R3D_BOTTLENECK_DEPTHS else 1)


class Conv3d(nn.Conv3d):
    """A bias-free ``nn.Conv3d`` whose weight is cast to the input's dtype,
    initialised like the JAX package's R3D convolutions (He-normal over the
    fan-out) from ``generator``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int, int], stride,
                 padding, generator: torch.Generator):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        fan_out = out_ch * math.prod(kernel)
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class FrozenBatchNorm(nn.BatchNorm3d):
    """Inference-mode BatchNorm3d with loaded statistics (the reference
    freezes every R3D BatchNorm, models.py:206-219): ``x * inv + (bias -
    mean * inv)`` with ``inv = weight / sqrt(var + eps)`` taken in f32 and
    both factors cast to x's dtype, step for step as the JAX package's
    ``FrozenBatchNorm``. The torch names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``) are the
    reference's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        shape = (1, -1, 1, 1, 1)
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


def _conv(in_ch, out_ch, kernel, stride, generator) -> Conv3d:
    return Conv3d(in_ch, out_ch, kernel, stride, tuple(k // 2 for k in kernel), generator)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, downsample: bool,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, (1, 1, 1), 1, generator)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, (3, 3, 3), stride, generator)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, (1, 1, 1), 1, generator)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(_conv(in_planes, planes * 4, (1, 1, 1), stride, generator),
                                            FrozenBatchNorm(planes * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + residual)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, downsample: bool,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, (3, 3, 3), stride, generator)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, (3, 3, 3), 1, generator)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(_conv(in_planes, planes, (1, 1, 1), stride, generator),
                                            FrozenBatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + residual)


def r3d_trunk(depth: int, generator: torch.Generator, conv1_t_size: int = 7,
              conv1_t_stride: int = 1) -> nn.Sequential:
    """The R3D feature extractor as the reference's ``nn.Sequential``:
    [B, 3, T, H, W] -> [B, out_features(depth), T', H', W']."""
    if depth not in R3D_DEPTH_BLOCKS:
        raise ValueError(f"R3D depth {depth} is not one of {sorted(R3D_DEPTH_BLOCKS)}")
    bottleneck = depth in R3D_BOTTLENECK_DEPTHS
    block_cls, expansion = (Bottleneck, 4) if bottleneck else (BasicBlock, 1)
    stem = Conv3d(3, 64, (conv1_t_size, 7, 7), (conv1_t_stride, 2, 2), (conv1_t_size // 2, 3, 3),
                  generator)
    stages = []
    in_planes = 64
    for stage, (planes, num_blocks) in enumerate(zip(R3D_STAGE_PLANES, R3D_DEPTH_BLOCKS[depth]),
                                                 start=1):
        blocks = []
        for b in range(num_blocks):
            stride = 2 if stage > 1 and b == 0 else 1
            downsample = b == 0 and (stride != 1 or in_planes != planes * expansion)
            blocks.append(block_cls(in_planes, planes, stride, downsample, generator))
            in_planes = planes * expansion
        stages.append(nn.Sequential(*blocks))
    return nn.Sequential(stem, FrozenBatchNorm(64), nn.ReLU(),
                         nn.MaxPool3d(3, stride=2, padding=1), *stages)
