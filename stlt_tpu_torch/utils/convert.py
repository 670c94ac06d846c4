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
- :func:`state_dict_to_jax_params` is its inverse: a port model's
  parameters as the JAX package's tree (the names from the modules' types,
  the parameters JAX never builds left out), which :func:`save_checkpoint`
  writes as flax's ``.msgpack`` (``utils/msgpack.py``), the JAX package's
  format, when the path ends in ``.msgpack`` and as a reference-format
  ``.pt`` otherwise.
- :func:`read_state_dict` reads either format (a ``.msgpack`` tree through
  :func:`jax_params_to_state_dict`); :func:`load_checkpoint` loads a file of
  either into a model: ``strict=True``, then ``strict=False`` with a
  warning, as ``stlt_tpu/inference.py:123-131`` does.
- :func:`load_kinetics_r3d` loads a Kinetics-format R3D state_dict
  (``conv1``, ``bn1``, ``layer1.0...``; ``fc`` ignored) into every R3D trunk
  of a model (own copy of ``stlt_tpu/utils/convert.py::load_kinetics_r3d``
  :157).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from stlt_tpu_torch.models.appearance import TransformerResnet
from stlt_tpu_torch.utils import msgpack

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


def _numpy(value) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor (``utils/msgpack.py`` reads a
    bf16 leaf as one) widened to f32, exactly: the port's parameters are
    f32."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree of any factory
    model (array or tensor leaves)."""
    out: Dict[str, np.ndarray] = {}
    inproj: Dict[str, list] = {}
    for path, value in _flatten(params).items():
        v = _numpy(value)
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


# The R3D trunk's nn.Sequential index -> its flax name (the inverse of
# _SEQUENTIAL_RESNET).
_TRUNK_NAMES = {index: name for name, index in _SEQUENTIAL_RESNET.items()}
_NO_JAX_LEAF = re.compile(r"(^|\.)(layout_embedding\.encoder_layer\.|position_ids$|num_batches_tracked$)")
_SCORES = re.compile(r"(^|\.)score_embeddings\.")


def _flax_parts(module_name: str) -> Tuple[str, ...]:
    """torch module path -> flax scope names, the inverse of
    :func:`_module_name` and :func:`_rewrap_sequential_resnet`: an R3D
    trunk's index is its layer's name (``resnet.4`` -> ``resnet/layer1``),
    an encoder's or a block's index joins with ``_`` (``layers_3``,
    ``downsample_0``), any other container's with ``.`` (``layer1.0``,
    ``mm_fusion.0``: one flax scope each)."""
    out = []
    for token in module_name.split(".") if module_name else ():
        if token.isdigit() and out:
            prev = out[-1]
            if prev == "resnet":
                out.append(_TRUNK_NAMES[token])
            else:
                out[-1] = f"{prev}_{token}" if prev in ("layers", "downsample") else f"{prev}.{token}"
            continue
        out.append(token)
    return tuple(out)


def jax_free_keys(model: nn.Module, *, scores: bool = False) -> Set[str]:
    """The ``state_dict`` keys of ``model`` without a leaf in the JAX
    package's tree: the ``position_ids`` and ``num_batches_tracked``
    buffers, the spatial encoder's dead prototype
    ``layout_embedding.encoder_layer``, ``score_embeddings`` unless
    ``scores`` (flax builds it only for batches with detector scores,
    Action Genome's), and the classifiers a ``TransformerResnet`` never
    runs: its trunk's ``resnet.classifier`` always, its own ``classifier``
    inside another model (a fusion model's appearance branch)."""
    state = model.state_dict()
    free = {k for k in state if _NO_JAX_LEAF.search(k) or (not scores and _SCORES.search(k))}
    for name, module in model.named_modules():
        if isinstance(module, TransformerResnet):
            base = f"{name}." if name else ""
            dead = (f"{base}resnet.classifier.",) + ((f"{base}classifier.",) if name else ())
            free.update(k for k in state if k.startswith(dead))
    return free


def state_dict_to_jax_params(model: nn.Module, *, scores: bool = False) -> Dict[str, Any]:
    """``model``'s parameters and BN statistics as the JAX package's tree
    (nested dicts of CPU tensors), the inverse of
    :func:`jax_params_to_state_dict`, named from the modules' types:
    ``LayerNorm`` -> ``scale``/``bias``; ``Embedding`` -> ``embedding``
    (the frame-position table a raw ``position_embeddings`` leaf);
    ``Linear``/``Conv3d`` -> ``kernel`` transposed back (``[O, I, kT, kH,
    kW]`` -> ``[kT, kH, kW, I, O]``) and ``bias``; BN -> ``scale``,
    ``bias``, ``mean``, ``var``; ``in_proj_weight``/``in_proj_bias`` split
    into ``q_proj``/``k_proj``/``v_proj``; other parameters (``cls_token``,
    ``pos_embed``) by their name. :func:`jax_free_keys` (``scores``: see
    there) are left out."""
    free = jax_free_keys(model, scores=scores)
    tree: Dict[str, Any] = {}

    def put(parts, value):
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for name, module in model.named_modules():
        own = list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False))
        parts = _flax_parts(name) if own else ()
        for leaf, value in own:
            if (f"{name}.{leaf}" if name else leaf) in free:
                continue
            v = value.detach().cpu()
            if leaf in ("in_proj_weight", "in_proj_bias"):
                for proj, third in zip(_QKV, v.chunk(3, dim=0)):
                    put(parts + (proj, "kernel" if leaf == "in_proj_weight" else "bias"),
                        third.t() if leaf == "in_proj_weight" else third)
            elif isinstance(module, nn.Embedding):
                put(parts if parts[-1] == "position_embeddings" else parts + ("embedding",), v)
            elif isinstance(module, (nn.Linear, nn.Conv3d)) and leaf == "weight":
                put(parts + ("kernel",), v.t() if v.dim() == 2 else v.permute(2, 3, 4, 1, 0))
            elif isinstance(module, (nn.LayerNorm, nn.BatchNorm3d)) and leaf == "weight":
                put(parts + ("scale",), v)
            elif leaf in ("running_mean", "running_var"):
                put(parts + (leaf[len("running_"):],), v)
            elif leaf != "weight":
                put(parts + (leaf,), v)
            else:
                raise ValueError(f"no JAX name for {type(module).__name__}.{leaf} at {name!r}")
    return tree


def save_checkpoint(path: str, module: nn.Module, *, scores: bool = False) -> None:
    """Write ``module``'s weights to ``path``: flax's ``.msgpack``
    (:func:`state_dict_to_jax_params`, which the JAX package's
    ``load_params`` takes) when it ends in ``.msgpack``, else a
    reference-format ``.pt`` state_dict. Either goes through a temporary
    file and ``os.replace``."""
    if path.endswith(".msgpack"):
        msgpack.write(path, state_dict_to_jax_params(module, scores=scores))
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, tmp)
    os.replace(tmp, path)


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


def read_state_dict(path: str, module: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The state_dict in the file at ``path``, on the CPU: a flax
    ``.msgpack`` tree (the JAX package's checkpoint, or a backbone's subtree)
    through :func:`jax_params_to_state_dict`, else a reference-format
    ``.pt``/``.pth``. Given the ``module`` it goes into, a ``.msgpack``
    file's missing entries that JAX never builds (:func:`jax_free_keys`:
    the dead classifiers of a backbone-only file, which the file cannot
    size) are taken from the module, which never runs them."""
    if path.endswith(".msgpack"):
        state = jax_params_to_state_dict(msgpack.read(path))
        if module is not None:
            own = module.state_dict()
            for key in jax_free_keys(module, scores=True):
                if key not in state:
                    state[key] = own[key].detach().cpu().clone()
        return state
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load the checkpoint at ``path`` (``.msgpack`` or ``.pt``) into
    ``model``: ``strict=True``, then ``strict=False`` with a warning. A
    position table of another row count is resampled to the model's."""
    state = read_state_dict(path, model)
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
