"""Carry weights across: JAX parameter trees and reference checkpoints.

- :func:`jax_params_to_state_dict` turns a parameter tree (nested dicts of
  arrays) of any of the JAX package's six models into this port's
  ``state_dict``. It is an own copy of
  ``stlt_tpu/utils/convert.py::flax_to_torch_state_dict`` (:238): Dense
  kernels transpose, Conv3d kernels ``[kT, kH, kW, I, O]`` become ``[O, I,
  kT, kH, kW]``, q/k/v restack into ``in_proj_*``, ``FrozenBatchNorm``'s
  ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
  ``running_mean``/``running_var`` (with ``num_batches_tracked``), the R3D
  trunk takes the reference's ``nn.Sequential`` numbering (``resnet.0`` =
  conv1 ... ``resnet.7`` = layer4), the position table gains its
  ``position_ids`` buffer, and the parameters the reference owns but never
  runs are filled in: the dead spatial prototype
  ``layout_embedding.encoder_layer.*`` copies ``layers.0``, and the unused
  ``score_embeddings`` and the appearance branch's dead classifiers are
  zeros.
- :func:`load_checkpoint` loads a reference-format ``.pt`` state_dict into a
  model: ``strict=True``, then ``strict=False`` with a warning, as
  ``stlt_tpu/inference.py:123-131`` does.
- :func:`load_kinetics_r3d` loads a Kinetics-format R3D state_dict
  (``conv1``, ``bn1``, ``layer1.0...``; ``fc`` ignored) into every R3D trunk
  of a model (own copy of ``stlt_tpu/utils/convert.py::load_kinetics_r3d``
  :157).
"""

from __future__ import annotations

import logging
import re
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
    """flax scope names -> torch module path (``layers_3`` -> ``layers.3``,
    ``downsample_0`` -> ``downsample.0``)."""
    def one(p: str) -> str:
        if p.startswith("layers_"):
            return f"layers.{p.split('_', 1)[1]}"
        if p in ("downsample_0", "downsample_1"):
            return p.replace("_", ".")
        return p

    return ".".join(one(p) for p in parts)


# The reference wraps the R3D trunk in nn.Sequential(*children[:-2])
# (models.py:205): 0 = conv1, 1 = bn1, 2 = relu, 3 = maxpool, 4..7 =
# layer1..layer4.
_SEQUENTIAL_RESNET = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
                      "layer4": "7"}
_SEQUENTIAL_RE = re.compile(r"(^|\.)resnet\.(conv1|bn1|layer1|layer2|layer3|layer4)\.")


def _rewrap_sequential_resnet(key: str) -> str:
    while True:
        m = _SEQUENTIAL_RE.search(key)
        if not m:
            return key
        key = f"{key[:m.start()]}{m.group(1)}resnet.{_SEQUENTIAL_RESNET[m.group(2)]}.{key[m.end():]}"


def _fill_dead_appearance_classifiers(out: Dict[str, np.ndarray]) -> None:
    """Zeros for the classifiers the reference builds in the appearance
    branch but never runs (``stlt_tpu/utils/convert.py:303-340``): the
    ``Resnet3D`` trunk's hardcoded ``Linear(2048, C)`` inside a
    ``TransformerResnet``, and the ``TransformerResnet``'s own classifier
    inside the fusion models (C from a head's ``fc2``)."""
    head_rows = next((v.shape[0] for k, v in out.items() if k.endswith("fc2.weight")), None)
    for key in list(out):
        if not key.endswith("projector.weight"):
            continue
        base = key[: -len("projector.weight")]  # a TransformerResnet
        own = out.get(f"{base}classifier.weight")
        rows = own.shape[0] if own is not None else head_rows
        if rows is None:
            continue
        if own is None:
            out[f"{base}classifier.weight"] = np.zeros((rows, out[key].shape[0]), np.float32)
            out[f"{base}classifier.bias"] = np.zeros((rows,), np.float32)
        if f"{base}resnet.resnet.0.weight" in out and f"{base}resnet.classifier.weight" not in out:
            out[f"{base}resnet.classifier.weight"] = np.zeros((rows, 2048), np.float32)
            out[f"{base}resnet.classifier.bias"] = np.zeros((rows,), np.float32)


_LEAVES = {"embedding": "weight", "scale": "weight", "kernel": "weight", "mean": "running_mean",
           "var": "running_var"}


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree of any factory
    model."""
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
        torch_leaf = _LEAVES.get(leaf, leaf)
        key = f"{module}.{torch_leaf}" if module else torch_leaf
        if leaf == "kernel":
            if v.ndim == 2:
                v = v.T
            elif v.ndim == 5:
                v = v.transpose(4, 3, 0, 1, 2)  # [kT, kH, kW, I, O] -> [O, I, kT, kH, kW]
            else:
                raise ValueError(f"unexpected kernel rank at {key}: {v.shape}")
        if leaf == "mean":
            out[f"{module}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
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
    out = {_rewrap_sequential_resnet(k): v for k, v in out.items()}
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
    _fill_dead_appearance_classifiers(out)
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


_KINETICS_TRUNK = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
                   "layer4": "7"}


def load_kinetics_r3d(model: nn.Module, path: str) -> nn.Module:
    """Load the Kinetics R3D checkpoint at ``path`` (a ``.pt``/``.pth``
    state_dict, possibly wrapped in ``{"state_dict": ...}``, keys ``conv1``,
    ``bn1``, ``layer1.0.conv1`` ...) into every raw R3D trunk of ``model``:
    each ``resnet`` ``nn.Sequential`` whose children are the reference's
    0 = conv1 ... 7 = layer4. The checkpoint's ``fc`` (and any key outside
    the trunk) is ignored, as the reference's ``children[:-2]`` strip drops
    it; a trunk parameter or statistic it lacks raises. A checkpoint without
    ``num_batches_tracked`` keeps the trunk's (an unused counter)."""
    state = read_state_dict(path)
    trunk_state = {}
    for key, value in state.items():
        head, _, rest = key.partition(".")
        if head in _KINETICS_TRUNK and rest:
            trunk_state[f"{_KINETICS_TRUNK[head]}.{rest}"] = value
    trunks = [m for name, m in model.named_modules()
              if name.split(".")[-1] == "resnet" and isinstance(m, nn.Sequential)]
    if not trunks:
        raise ValueError(f"{type(model).__name__} has no R3D trunk to load {path} into")
    for trunk in trunks:
        own = trunk.state_dict()
        missing = [k for k in own if k not in trunk_state and not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"{path}: no Kinetics R3D parameter for {missing[:5]}")
        with torch.no_grad():
            for key, value in own.items():
                if key in trunk_state:
                    if tuple(trunk_state[key].shape) != tuple(value.shape):
                        raise ValueError(f"{path}: {key} has shape {tuple(trunk_state[key].shape)}, "
                                         f"the trunk {tuple(value.shape)}")
                    value.copy_(trunk_state[key])
    return model
