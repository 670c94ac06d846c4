"""Carry weights across: JAX parameter trees and reference checkpoints.

- :func:`jax_params_to_state_dict` turns the JAX package's STLT parameter
  tree (nested dicts of arrays) into this port's ``state_dict``. It is an own
  copy of the STLT part of ``stlt_tpu/utils/convert.py::flax_to_torch_state_dict``
  (:238): kernels transpose, q/k/v restack into ``in_proj_*``, the position
  table gains its ``position_ids`` buffer, the dead spatial prototype
  ``layout_embedding.encoder_layer.*`` copies ``layers.0`` and the unused
  ``score_embeddings`` are zero-filled.
- :func:`load_checkpoint` loads a reference-format ``.pt`` state_dict into a
  model: ``strict=True``, then ``strict=False`` with a warning, as
  ``stlt_tpu/inference.py:123-131`` does.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_QKV = {"q_proj": 0, "k_proj": 1, "v_proj": 2}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _module_name(parts) -> str:
    """flax scope names -> torch module path (``layers_3`` -> ``layers.3``)."""
    return ".".join(f"layers.{p.split('_', 1)[1]}" if p.startswith("layers_") else p for p in parts)


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX STLT parameter tree."""
    out: Dict[str, np.ndarray] = {}
    inproj: Dict[str, list] = {}
    for path, value in _flatten(params).items():
        v = np.asarray(value)
        module, leaf = _module_name(path[:-1]), path[-1]
        if len(path) >= 2 and path[-2] in _QKV:
            slot = "in_proj_weight" if leaf == "kernel" else "in_proj_bias"
            parts = inproj.setdefault(f"{_module_name(path[:-2])}.{slot}", [None] * 3)
            parts[_QKV[path[-2]]] = v.T if leaf == "kernel" else v
            continue
        torch_leaf = {"embedding": "weight", "scale": "weight", "kernel": "weight"}.get(leaf, leaf)
        key = f"{module}.{torch_leaf}" if module else torch_leaf
        if leaf == "kernel":
            if v.ndim != 2:
                raise ValueError(f"unexpected kernel rank at {key}: {v.shape}")
            v = v.T
        if leaf == "position_embeddings":
            # nn.Embedding on the torch side, plus its registered arange buffer.
            out[f"{key[:-len('position_embeddings')]}position_ids"] = (
                np.arange(v.shape[0], dtype=np.int64)[None]
            )
            key = f"{key}.weight"
        out[key] = v
    for key, parts in inproj.items():
        assert all(p is not None for p in parts), f"incomplete q/k/v at {key}"
        out[key] = np.concatenate(parts, axis=0)
    marker = ".layout_embedding.transformer.layers.0."
    for key in list(out):
        if marker in key:
            head, rest = key.split(marker, 1)
            out[f"{head}.layout_embedding.encoder_layer.{rest}"] = out[key]
    for key in list(out):
        if key.endswith("category_embeddings.weight"):
            base = key[: -len("category_embeddings.weight")]
            if f"{base}score_embeddings.weight" not in out:
                hidden = out[key].shape[1]
                out[f"{base}score_embeddings.weight"] = np.zeros((hidden, 1), np.float32)
                out[f"{base}score_embeddings.bias"] = np.zeros((hidden,), np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def resize_position_table(table: torch.Tensor, rows: int) -> torch.Tensor:
    """Resample a learned ``[rows_old, H]`` position table to ``rows`` by
    align-corners linear interpolation over the frame index (own copy of
    ``stlt_tpu/utils/convert.py::resize_position_table`` :362, its default
    mode)."""
    old = table.shape[0]
    if old == rows:
        return table
    if old < 2:
        raise ValueError(f"cannot resample a {old}-row position table")
    pos = np.linspace(0.0, float(old - 1), rows)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, old - 1)
    frac = (pos - lo)[:, None]
    t = table.detach().cpu().numpy().astype(np.float64)
    return torch.from_numpy((t[lo] * (1.0 - frac) + t[hi] * frac).astype(np.float32))


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pt``/``.pth`` state_dict, on the CPU."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: the port reads reference-format .pt state_dicts; export a "
            "JAX .msgpack checkpoint with stlt_tpu.utils.convert.save_torch_checkpoint "
            "(or tools/export_torch_checkpoint.py) first"
        )
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load the checkpoint at ``path`` into ``model``: ``strict=True``, then
    ``strict=False`` with a warning. A position table of another row count
    is resampled to the model's."""
    state = read_state_dict(path)
    own = model.state_dict()
    for key, value in list(state.items()):
        if (key.endswith("position_embeddings.weight") and key in own
                and value.shape != own[key].shape and value.dim() == 2
                and value.shape[1] == own[key].shape[1]):
            rows = own[key].shape[0]
            state[key] = resize_position_table(value, rows)
            state[f"{key[:-len('position_embeddings.weight')]}position_ids"] = (
                torch.arange(rows)[None]
            )
    try:
        model.load_state_dict(state, strict=True)
    except RuntimeError as e:
        logging.warning(
            "Default loading failed, loading with strict=False. If it's only "
            "score_embedding modules it's ok. Otherwise see exception below"
        )
        logging.warning("%s", e)
        model.load_state_dict(state, strict=False)
    return model
