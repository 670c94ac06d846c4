"""flax's ``.msgpack`` checkpoint format in the port
(``stlt_tpu_torch/utils/msgpack.py``, ``utils/convert.py``) against flax,
on the CPU.

- The format: trees of maps, str, ints, floats, bool, nil and arrays of
  every dtype flax writes (bf16 among them, by its name), numpy scalars and
  chunked leaves: the port's bytes equal ``flax.serialization``'s, and each
  reads the other's; an unknown ext code or dtype is refused in the
  module's words.
- The golden ``tests/data/golden_stlt_params.msgpack`` (written by flax) is
  read in a subprocess that imports torch, numpy and the port only (neither
  ``flax`` nor ``msgpack`` nor ``jax`` is in ``sys.modules`` at its end) and
  reproduces ``golden_stlt_io.npz``'s logits at ``tests/test_golden.py``'s
  tolerance (atol 2e-5, rtol 1e-5).
- For each of the six factory models (STLT with and without the score
  embedding), weights carried from a seeded port model into JAX's
  ``jax.eval_shape`` tree (``tests/test_torch_fusion.py::carried_params``):
  the ``.msgpack`` the port writes equals flax's ``to_bytes`` of JAX's
  tree byte for byte, flax's
  ``msgpack_restore`` gives back JAX's tree bit for bit, the JAX package's
  ``load_params`` takes it, and the port reads it back into the model's
  own ``state_dict``; a backbone-only file (STLT's, CACNF's) loads into
  ``model.backbone`` with ``strict=True``.
- A ``.msgpack`` position table of another row count is resampled as a
  ``.pt``'s is.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.training.checkpoint import load_params as jax_load_params
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.utils import msgpack
from stlt_tpu_torch.utils.convert import (
    jax_free_keys,
    jax_params_to_state_dict,
    read_state_dict,
    save_checkpoint,
)
from tests.test_stlt_parity import small_config
from tests.test_torch_fusion import carried_params, jax_model, model_inputs, port_config
from tests.test_torch_model import _inputs as stlt_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
STLT_KW = dict(num_classes=11, unique_categories=4, hidden_size=64, num_attention_heads=4,
               num_spatial_layers=2, num_temporal_layers=2, layout_num_frames=32)


# --- the format --------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(0)
    return {
        "layer": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": np.zeros((300,), np.float32)},
        "ints": np.arange(70000, dtype=np.int64).reshape(7, 10000),
        "f32_scalar": np.float32(3.5), "i32_scalar": np.int32(-7),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((5, 2)), jnp.bfloat16)),
        "u8": np.arange(17, dtype=np.uint8), "mask": np.array([True, False]),
        "f64": rng.standard_normal((2, 2)), "empty": np.zeros((0, 3), np.float32),
        "wide": {str(i): np.full((i,), i, np.float16) for i in range(20)},
        "plain": {"s": "x" * 40, "n": None, "t": True, "i": -200, "big": 2 ** 40, "f": 0.25,
                  "list": [1, -3, 300]},
    }


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(), want.astype(np.float32))
        else:
            assert tuple(got.shape) == want.shape and np.array_equal(got.numpy(), want)
    else:
        assert got == want


def test_msgpack_bytes_equal_flax_and_read_back():
    tree = _tree()
    data = msgpack.serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _same(msgpack.restore(data), tree)
    back = serialization.msgpack_restore(data)
    assert np.array_equal(back["ints"], tree["ints"]) and back["f32_scalar"] == np.float32(3.5)


def test_msgpack_chunked_leaves_equal_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"x": np.arange(100, dtype=np.float32).reshape(4, 25), "y": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert msgpack.serialize(tree) == data
    _same(msgpack.restore(data), tree)


def test_msgpack_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="ext code 2"):
        msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    payload = msgpack.packb([[2], "float8_e4m3fn", b"\x00\x00"])
    with pytest.raises(ValueError, match="dtype 'float8_e4m3fn' is not one the port reads"):
        msgpack.restore(b"\x81\xa1a\xc7" + bytes([len(payload)]) + b"\x01" + payload)
    with pytest.raises(ValueError, match="cannot write a set"):
        msgpack.serialize({"a": {1, 2}})


# --- the golden file without flax -------------------------------------------------


GOLDEN = """
import json, sys
import numpy as np, torch
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.utils.convert import load_checkpoint
cfg, data = json.loads(sys.argv[1]), sys.argv[2]
blob = np.load(data + "/golden_stlt_io.npz")
model = models_factory["stlt"](StltModelConfig(**cfg)).eval()
load_checkpoint(data + "/golden_stlt_params.msgpack", model)
inputs = {k[3:]: torch.from_numpy(blob[k]) for k in blob.files if k.startswith("in_")}
with torch.inference_mode():
    got = model(inputs)["stlt"].numpy()
np.testing.assert_allclose(got, blob["logits"], atol=2e-5, rtol=1e-5)
print(json.dumps({"max_abs_err": float(np.abs(got - blob["logits"]).max()),
                  "modules": [m for m in ("flax", "msgpack", "jax") if m in sys.modules]}))
"""


def test_golden_msgpack_reproduces_the_golden_logits_without_flax():
    fields = {f.name for f in dataclasses.fields(StltModelConfig)}
    cfg = {k: v for k, v in dataclasses.asdict(small_config()).items() if k in fields}
    out = subprocess.run([sys.executable, "-c", GOLDEN, json.dumps(cfg), DATA],
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] == [], result
    assert result["max_abs_err"] <= 2e-5


# --- the six models: the port's .msgpack is JAX's ----------------------------------


def _stlt_case(scores: bool):
    cfg = JaxStltConfig(**STLT_KW)
    params = carried_params("stlt", cfg, jax_models["stlt"](cfg),
                            stlt_inputs(False, with_scores=scores), seed=1)
    return params, models_factory["stlt"](StltModelConfig(**STLT_KW))


def _carried_case(name: str):
    cfg, model = jax_model(name, 7)
    params = carried_params(name, cfg, model, model_inputs(7, (3, 7), seed=1), seed=1)
    return params, models_factory[name](port_config(name, cfg))


def _flat(tree):
    return traverse_util.flatten_dict(serialization.to_state_dict(tree))


@pytest.mark.parametrize("name,scores", [
    ("stlt", False), ("stlt", True), ("resnet3d", False), ("resnet3d-transformer", False),
    ("lcf", False), ("caf", False), ("cacnf", False),
])
def test_port_msgpack_is_jax_tree(name, scores, tmp_path):
    params, model = _stlt_case(scores) if name == "stlt" else _carried_case(name)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    path = str(tmp_path / "best.msgpack")
    save_checkpoint(path, model, scores=scores)
    with open(path, "rb") as f:
        data = f.read()
    jax_tree = jax.tree_util.tree_map(np.asarray, params)
    assert data == serialization.to_bytes(jax_tree)
    got, want = _flat(serialization.msgpack_restore(data)), _flat(jax_tree)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
    loaded = _flat(jax_load_params(path, jax_tree))
    assert all(np.array_equal(loaded[k], want[k]) for k in want)
    back = read_state_dict(path, model)
    own = model.state_dict()
    assert set(back) == set(own)
    for key, value in own.items():
        assert torch.equal(back[key], value), key


@pytest.mark.parametrize("name", ["stlt", "cacnf"])
def test_backbone_msgpack_loads_strict_into_the_backbone(name, tmp_path):
    params, model = _stlt_case(False) if name == "stlt" else _carried_case(name)
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    path = str(tmp_path / "backbone.msgpack")
    save_checkpoint(path, model.backbone)
    got = _flat(serialization.msgpack_restore(open(path, "rb").read()))
    want = _flat(jax.tree_util.tree_map(np.asarray, params["backbone"]))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    other = (_stlt_case(False) if name == "stlt" else _carried_case(name))[1]
    other.backbone.load_state_dict(read_state_dict(path, other.backbone), strict=True)
    free = jax_free_keys(model.backbone)
    for key, value in model.backbone.state_dict().items():
        if key not in free:
            assert torch.equal(other.backbone.state_dict()[key], value), key


def test_msgpack_backbone_without_a_module_misses_the_dead_classifiers(tmp_path):
    """A CACNF backbone file cannot size its appearance branch's dead
    classifiers: read without the module they are missing, and the strict
    load names them."""
    params, model = _carried_case("cacnf")
    path = str(tmp_path / "backbone.msgpack")
    save_checkpoint(path, model.backbone)
    with pytest.raises(RuntimeError, match="appearance_branch.classifier.weight"):
        model.backbone.load_state_dict(read_state_dict(path), strict=True)


def test_msgpack_position_table_is_resampled_to_the_model():
    """A ``.msgpack`` whose position table has another row count loads with
    its table resampled as a ``.pt``'s is (``load_checkpoint``), to the JAX
    package's ``resize_position_table``."""
    from stlt_tpu.utils.convert import resize_position_table as jax_resize_position_table
    from stlt_tpu_torch.utils.convert import load_checkpoint

    fields = {f.name for f in dataclasses.fields(StltModelConfig)}
    cfg = {k: v for k, v in dataclasses.asdict(small_config()).items() if k in fields}
    model = models_factory["stlt"](StltModelConfig(**dict(cfg, layout_num_frames=45)))
    path = os.path.join(DATA, "golden_stlt_params.msgpack")
    load_checkpoint(path, model)
    table = msgpack.read(path)["backbone"]["frames_embeddings"]["position_embeddings"]
    key = "backbone.frames_embeddings.position_embeddings.weight"
    want = jax_resize_position_table(table.numpy(), 45)
    np.testing.assert_allclose(model.state_dict()[key].numpy(), want, atol=1e-6)
    assert tuple(model.state_dict()["backbone.frames_embeddings.position_ids"].shape) == (1, 45)
