"""Parameter partitioning over the ``model`` axis (tensor parallelism): own
copy of ``stlt_tpu/parallel/sharding.py``'s rules (:29-44), written against
the port's parameter names.

Megatron-style, as JAX shards a replica's parameters over M model ranks:

- column-sharded (output features split over the model axis): ``q_proj``,
  ``k_proj``, ``v_proj``, ``linear1`` and ``fc1``, weights and biases;
- row-sharded (input features split): ``out_proj`` and ``linear2``,
  weights only;
- replicated: everything else (embeddings, layer norms, the heads'
  ``fc2``, the row-sharded layers' biases, the R3D trunk).

Two traps of the port's names:

- torch's ``nn.Linear.weight`` is ``[out, in]``, the transpose of flax's
  ``kernel``: a column shard of the kernel, ``P(None, model)``, is dim 0 of
  the torch weight, and a row shard, ``P(model, None)``, is dim 1;
- q, k and v are stacked in ``in_proj_weight [3H, H]`` and ``in_proj_bias
  [3H]`` (``models/layers.py``): model rank m holds three slices of H/M
  rows, one from each third, and with the heads contiguous in each third
  its heads are [m N/M, (m + 1) N/M).

M must divide what it shards: the heads, FF and H. JAX's GSPMD pads an
uneven shard; the port refuses one (:func:`check_model_axis`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

_COLUMN_PARALLEL = {"linear1", "fc1"}
_ROW_PARALLEL = {"out_proj", "linear2"}
_STACKED_QKV = {"in_proj_weight", "in_proj_bias"}


def param_spec(name: str) -> Optional[int]:
    """The torch dimension of parameter ``name`` (a ``state_dict`` key)
    that the model axis shards, or None when it is replicated. The stacked
    ``in_proj_*`` are sharded on dim 0 in three thirds (:func:`shard_tensor`)."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf in _STACKED_QKV:
        return 0
    module = parts[-2] if len(parts) >= 2 else ""
    if module in _COLUMN_PARALLEL and leaf in ("weight", "bias"):
        return 0
    if module in _ROW_PARALLEL and leaf == "weight":
        return 1
    return None


def shard_tensor(name: str, value: torch.Tensor, model_size: int, model_index: int) -> torch.Tensor:
    """Model rank ``model_index``'s shard of parameter ``name`` (a copy; the
    value itself when it is replicated). Raises when M does not divide the
    sharded dimension."""
    dim = param_spec(name)
    if dim is None or model_size == 1:
        return value
    thirds = 3 if name.split(".")[-1] in _STACKED_QKV else 1
    full = value.shape[dim]
    if full % (thirds * model_size):
        raise ValueError(f"--model_parallel {model_size} does not divide dim {dim} of {name} "
                         f"{tuple(value.shape)}")
    width = full // (thirds * model_size)
    parts = [value.narrow(dim, i * full // thirds + model_index * width, width) for i in range(thirds)]
    return torch.cat(parts, dim=dim).clone()


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's local state dict of the full one ``full``: every sharded
    parameter cut to the rank's model index (:func:`shard_tensor`), the rest
    as they are."""
    return {k: shard_tensor(k, v, mesh.model_size, mesh.model_index) for k, v in full.items()}


def check_model_axis(model_parallel: int, hidden_size: int, num_heads: int) -> None:
    """Refuse a model axis that does not divide the heads, H or FF = 4H (a
    documented difference from JAX, whose GSPMD pads uneven shards)."""
    if model_parallel <= 1:
        return
    for what, n in (("--num_attention_heads", num_heads), ("--hidden_size", hidden_size),
                    ("the feed-forward width 4 H", 4 * hidden_size)):
        if n % model_parallel:
            raise ValueError(f"--model_parallel {model_parallel} does not divide {what} ({n}): "
                             "the port shards the heads, H and FF evenly (JAX's GSPMD would pad)")


def shard_model_(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model``'s parameters to this rank's shards in place
    (:func:`shard_state_dict`) and every attention module's ``num_heads``
    to its N / M local heads; a no-op without a model axis. The model is
    then at its local widths."""
    M = mesh.model_size
    if M == 1:
        return model
    local = shard_state_dict({n: p.detach() for n, p in model.named_parameters()}, mesh)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if param_spec(name) is not None:
                param.data = local[name].to(param.device)
    for module in model.modules():
        heads = getattr(module, "num_heads", None)
        if heads is not None and hasattr(module, "in_proj_weight"):
            if heads % M:
                raise ValueError(f"--model_parallel {M} does not divide the {heads} heads")
            module.num_heads = heads // M
    return model
