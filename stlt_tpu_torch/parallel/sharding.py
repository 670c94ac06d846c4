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

Training keeps every rank's state at its shards: :func:`shard_model_` cuts
the model before AdamW is built (so its moments are shards from birth) and
marks each sharded parameter (``model_shard_dim``, which the clip's norm
reads). What a checkpoint holds is always full: :func:`gather_state_dict`
(the inverse of :func:`shard_state_dict`) and :func:`full_widths` give
every rank the full tensors, and AdamW's state is cut and gathered by its
parameter's spec (:func:`shard_optimizer_state`,
:func:`gather_optimizer_state`), as JAX's ``tree_shardings_like`` gives the
moments their parameter's sharding. Gathering is collective: every rank of
a model group calls it, in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from stlt_tpu_torch.parallel.mesh import all_gather

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


def gather_tensor(name: str, local: torch.Tensor, mesh) -> torch.Tensor:
    """The full parameter ``name`` from every model rank's shard ``local``
    (the inverse of :func:`shard_tensor`; collective over
    ``mesh.model_group`` when it is sharded, the bits exchanged as they
    are); ``local`` itself when it is replicated."""
    dim = param_spec(name)
    if dim is None or mesh.model_size == 1:
        return local
    parts = list(all_gather(local.detach(), mesh, mesh.model_group))
    if name.split(".")[-1] in _STACKED_QKV:  # each shard holds a third of q, of k and of v
        thirds = [p.chunk(3, dim=dim) for p in parts]
        return torch.cat([t[i] for i in range(3) for t in thirds], dim=dim)
    return torch.cat(parts, dim=dim)


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from this rank's local one (every rank calls it,
    with the same keys; every rank gets the full tensors)."""
    return {k: gather_tensor(k, v, mesh) for k, v in local.items()}


def _attention_modules(model: nn.Module):
    return [m for m in model.modules()
            if getattr(m, "num_heads", None) is not None and hasattr(m, "in_proj_weight")]


@contextlib.contextmanager
def full_widths(model: nn.Module, mesh):
    """Within the block ``model`` holds its full parameters and heads, a
    one-process model (its ``state_dict``, ``utils/convert.save_checkpoint``
    read it as such), then its shards again. Collective: every rank of the
    model group enters it. A no-op without a model axis."""
    if mesh is None or mesh.model_size == 1:
        yield model
        return
    params = dict(model.named_parameters())
    local = {n: p.data for n, p in params.items()}
    full = gather_state_dict(local, mesh)
    attention = _attention_modules(model)
    try:
        for n, p in params.items():
            p.data = full[n]
        for module in attention:
            module.num_heads *= mesh.model_size
        yield model
    finally:
        for n, p in params.items():
            p.data = local[n]
        for module in attention:
            module.num_heads //= mesh.model_size


def optimizer_param_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    """The parameter name of each index of ``optimizer.state_dict()``'s
    state (its groups' parameters in order)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _map_optimizer_state(state: Mapping[str, Any], names: List[str], fn) -> Dict[str, Any]:
    out = dict(state)
    out["state"] = {idx: {k: fn(names[idx], v) if torch.is_tensor(v) and v.dim() > 0 else v
                          for k, v in sorted(entry.items())}
                    for idx, entry in sorted(state["state"].items())}
    return out


def shard_optimizer_state(full: Mapping[str, Any], names: List[str], mesh) -> Dict[str, Any]:
    """This rank's cut of a full AdamW state dict (``exp_avg`` and
    ``exp_avg_sq`` cut as their parameter ``names[idx]``, the step counts
    as they are)."""
    return _map_optimizer_state(full, names,
                                lambda n, v: shard_tensor(n, v, mesh.model_size, mesh.model_index))


def gather_optimizer_state(local: Mapping[str, Any], names: List[str], mesh) -> Dict[str, Any]:
    """The full AdamW state dict from this rank's (collective, every rank
    gets it): the inverse of :func:`shard_optimizer_state`."""
    return _map_optimizer_state(local, names, lambda n, v: gather_tensor(n, v, mesh))


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
    (:func:`shard_state_dict`), each sharded one marked with its
    ``model_shard_dim``, and every attention module's ``num_heads`` to its
    N / M local heads; a no-op without a model axis. The model is then at
    its local widths."""
    M = mesh.model_size
    if M == 1:
        return model
    local = shard_state_dict({n: p.detach() for n, p in model.named_parameters()}, mesh)
    with torch.no_grad():
        for name, param in model.named_parameters():
            dim = param_spec(name)
            if dim is not None:
                param.data = local[name].to(param.device)
                param.model_shard_dim = dim
    for module in _attention_modules(model):
        if module.num_heads % M:
            raise ValueError(f"--model_parallel {M} does not divide the {module.num_heads} heads")
        module.num_heads //= M
    return model
