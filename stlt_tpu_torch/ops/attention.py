"""Scaled-dot-product attention core: port of
``stlt_tpu/ops/attention.py::dot_product_attention`` (:72).

A thin dispatcher over :func:`stlt_tpu_torch.ops.flash.flash_attention`. As
everywhere in the port, the tensor's device chooses the route (the CUDA
kernels on the card, their plain versions on the CPU); ``use_pallas`` is
accepted for the JAX signature and does not change it. Shapes are ``[batch,
seq, heads, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from stlt_tpu_torch.ops.flash import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    use_pallas: bool = False,
    dropout_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    dropout_row0: int = 0,
    dropout_head0: int = 0,
    dropout_heads: Optional[int] = None,
) -> torch.Tensor:
    """q: [B, T, N, D]; k, v: [B, S, N, D]; returns [B, T, N, D] in v's
    dtype (see ``flash_attention``; ``dropout_row0`` the global index of
    q's first row and ``dropout_head0`` that of its first head among
    ``dropout_heads``, at which a seed's keep bits are hashed)."""
    del use_pallas  # the device decides
    return flash_attention(
        q, k, v, bias=bias, dropout_mask=dropout_mask, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, causal=causal, kv_lengths=kv_lengths, dropout_row0=dropout_row0,
        dropout_head0=dropout_head0, dropout_heads=dropout_heads,
    )
