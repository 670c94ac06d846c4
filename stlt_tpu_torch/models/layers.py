"""Post-LN transformer encoder blocks, eval only.

Port of ``stlt_tpu/models/layers.py``: ``apply_layer_norm`` (:106),
``MultiHeadAttention`` (:131), ``activation_fn`` (:377),
``TransformerEncoderLayer`` (:390) and ``TransformerEncoder`` (:564).
Attribute names are the reference's torch names (the keys
``stlt_tpu.utils.convert.flax_to_torch_state_dict`` emits):
``self_attn.in_proj_weight``/``in_proj_bias``/``out_proj``, ``linear1``,
``linear2``, ``norm1``, ``norm2`` and ``layers.N``. Parameters are f32 and
are cast to the compute dtype where the JAX code casts.

Every encoder layer is exactly two fused ops (``ops/fused_encoder``):
projection+attention, then the layer tail. They run the CUDA kernels on a
CUDA tensor and their plain versions on a CPU tensor. Dropout is not part
of the eval path; training is a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stlt_tpu_torch.ops import fused_encoder as fe


def apply_layer_norm(x, scale, bias, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax.linen.LayerNorm step for step: promote to f32, fast variance
    clipped at 0, scale folded into the rsqrt, output cast to ``dtype``."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(torch.float32)
    return ((x32 - mu) * mul + bias.to(torch.float32)).to(dtype)


def apply_dense(x, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on a torch Linear's parameters: operands
    and bias in the compute dtype, the product rounded before the bias add."""
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y + linear.bias.to(dtype)


def activation_fn(name: str, dtype: torch.dtype):
    """GELU is exact erf in f32 and the tanh approximation in bf16, taken
    op for op in the input's dtype as ``jax.nn.gelu`` takes it."""
    approximate = dtype == torch.bfloat16
    return lambda x: fe.activation_fn(x, name, approximate)


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_linear_(linear: nn.Linear, generator: torch.Generator, *, zero_bias: bool = False) -> None:
    """torch ``nn.Linear`` default init, U(+-1/sqrt(fan_in)), from ``generator``."""
    bound = 1.0 / math.sqrt(linear.in_features)
    uniform_(linear.weight, bound, generator)
    if zero_bias:
        nn.init.zeros_(linear.bias)
    else:
        uniform_(linear.bias, bound, generator)


class MultiHeadAttention(nn.Module):
    """Self-attention with torch ``nn.MultiheadAttention``'s parameters."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        assert hidden_size % num_heads == 0
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden_size))
        self.out_proj = nn.Linear(hidden_size, hidden_size)
        # xavier-uniform over the stacked [3H, H] weight, zero biases.
        uniform_(self.in_proj_weight, math.sqrt(6.0 / (4.0 * hidden_size)), generator)
        init_linear_(self.out_proj, generator, zero_bias=True)

    def forward(self, x, bias=None, rows_live=None) -> torch.Tensor:
        return fe.fused_proj_attention(
            x.to(self.dtype), self.in_proj_weight.t(), self.in_proj_bias,
            self.out_proj.weight.t(), self.out_proj.bias, bias,
            num_heads=self.num_heads, compute_dtype=self.dtype, rows_live=rows_live,
        )


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch ``nn.TransformerEncoderLayer``'s
    parameters: ``norm2(u + FFN(u))`` for ``u = norm1(x + self_attn(x))``."""

    def __init__(self, hidden_size: int, num_heads: int, ff_size: int, *,
                 activation: str, layer_norm_eps: float, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.activation = activation
        self.layer_norm_eps = layer_norm_eps
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, dtype, generator)
        self.linear1 = nn.Linear(hidden_size, ff_size)
        self.linear2 = nn.Linear(ff_size, hidden_size)
        self.norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        init_linear_(self.linear1, generator)
        init_linear_(self.linear2, generator)

    def forward(self, x, bias=None, rows_live=None, tokens_live=None) -> torch.Tensor:
        attn_out = self.self_attn(x, bias, rows_live=rows_live)
        return fe.fused_layer_tail(
            x, attn_out, self.norm1.weight, self.norm1.bias,
            self.linear1.weight.t(), self.linear1.bias,
            self.linear2.weight.t(), self.linear2.bias,
            self.norm2.weight, self.norm2.bias,
            eps=self.layer_norm_eps, compute_dtype=self.dtype,
            activation=self.activation,
            gelu_approximate=self.dtype == torch.bfloat16,
            rows_live=rows_live, tokens_live=tokens_live,
        )


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (torch ``nn.TransformerEncoder``)."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int, ff_size: int, *,
                 activation: str, layer_norm_eps: float, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                hidden_size, num_heads, ff_size, activation=activation,
                layer_norm_eps=layer_norm_eps, dtype=dtype, generator=generator,
            )
            for _ in range(num_layers)
        )

    def forward(self, x, bias=None, rows_live=None, tokens_live=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias, rows_live=rows_live, tokens_live=tokens_live)
        return x
