"""The port's STLT (stlt_tpu_torch, plain versions on the CPU) against the
JAX package's STLT, with weights carried across by
``stlt_tpu_torch.utils.convert``.

Same numpy-seeded batches through both. Tolerances:

- f32 logits: atol 2e-5 (the golden test's), rtol 1e-5. Both compute the
  same f32 function; only the order of sums differs.
- bf16 logits: atol 3e-2 (four bf16 steps at |logit| ~ 1). Against
  ``use_pallas=True`` the port rounds at the same points as the Pallas
  kernels, but XLA on the CPU keeps the kernels' bf16 residual sums in f32
  (``--xla_allow_excess_precision``, on by default), so LayerNorm inputs
  differ by a bf16 rounding; ``tests/test_torch_ops.py`` shows the port
  bit-exact with that flag off. Against ``use_pallas=False`` the XLA chain
  also adds the tail's biases in bf16 where the kernels add them in f32.
"""

import dataclasses
import functools
import logging
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.utils.convert import (
    flax_to_torch_state_dict,
    resize_position_table as jax_resize_position_table,
    save_torch_checkpoint,
)
from stlt_tpu_torch.configs import StltModelConfig
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import fused_encoder as tfe
from stlt_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_checkpoint,
    resize_position_table,
)
from tests.test_stlt_parity import small_config

# Every kernel wrapper's launch count: none runs on a CPU tensor.
ALL_KERNELS = ("fused_proj_attention", "fused_layer_tail", "fused_proj_attention_train",
               "fused_proj_attention_train_bwd", "fused_cross_attention")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LOGITS_TOL = {
    "float32": dict(atol=2e-5, rtol=1e-5),
    "bfloat16": dict(atol=3e-2, rtol=0.0),
}
MODEL_KW = dict(
    num_classes=11, unique_categories=4, hidden_size=64, num_attention_heads=4,
    num_spatial_layers=2, num_temporal_layers=2, layout_num_frames=32,
)


def _port_config(jax_cfg) -> StltModelConfig:
    fields = {f.name for f in dataclasses.fields(StltModelConfig)}
    return StltModelConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in fields})


def _port_model(jax_cfg, params):
    model = models_factory["stlt"](_port_config(jax_cfg)).eval()
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def _port_logits(model, inputs):
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in inputs.items()})["stlt"]
    assert out.dtype == torch.float32
    return out.numpy()


def _inputs(ragged: bool, seed: int = 1, with_scores: bool = False):
    batch = _synthetic_layout_batch(
        4, 17, 8, 4, seed=seed, length_range=(3, 17) if ragged else None
    )
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    if with_scores:
        rng = np.random.default_rng(seed)
        inputs["scores"] = rng.uniform(0.3, 1.0, batch["categories"].shape).astype(np.float32)
    return inputs


@functools.lru_cache(maxsize=None)
def _jax_params(dtype: str, with_scores: bool = False):
    cfg = JaxStltConfig(compute_dtype=dtype, **MODEL_KW)
    return jax_models["stlt"](cfg).init(
        jax.random.PRNGKey(0), _inputs(False, with_scores=with_scores)
    )["params"]


def _golden():
    blob = np.load(os.path.join(DATA, "golden_stlt_io.npz"))
    inputs = {k[3:]: blob[k] for k in blob.files if k.startswith("in_")}
    cfg = small_config()
    template = jax_models["stlt"](cfg).init(jax.random.PRNGKey(0), inputs)["params"]
    with open(os.path.join(DATA, "golden_stlt_params.msgpack"), "rb") as f:
        params = serialization.from_bytes(template, f.read())
    return cfg, params, inputs, blob["logits"]


# --- (c) the golden fixture ---------------------------------------------------


def test_golden_stlt_logits_reproduced():
    cfg, params, inputs, expected = _golden()
    got = _port_logits(_port_model(cfg, params), inputs)
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=1e-5)


# --- (b) carrying weights across ------------------------------------------------


@pytest.mark.parametrize("with_scores", [False, True])
def test_jax_params_to_state_dict_equals_flax_export(with_scores):
    params = _jax_params("float32", with_scores)
    want = flax_to_torch_state_dict(params)
    got = jax_params_to_state_dict(params)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
        assert got[key].dtype == torch.from_numpy(np.array(value)).dtype, key
    model = models_factory["stlt"](_port_config(JaxStltConfig(**MODEL_KW)))
    model.load_state_dict(got, strict=True)
    assert any(k.endswith("layout_embedding.encoder_layer.linear1.weight") for k in got)
    assert any(k.endswith("frames_embeddings.position_ids") for k in got)


def test_load_checkpoint_reads_exported_pt(tmp_path, caplog):
    cfg, params, inputs, expected = _golden()
    path = str(tmp_path / "golden.pt")
    save_torch_checkpoint(path, params)
    model = models_factory["stlt"](_port_config(cfg)).eval()
    with caplog.at_level(logging.WARNING):
        load_checkpoint(path, model)
    assert "strict=False" not in caplog.text
    np.testing.assert_allclose(_port_logits(model, inputs), expected, atol=2e-5, rtol=1e-5)


def test_load_checkpoint_falls_back_to_non_strict_with_a_warning(tmp_path, caplog):
    cfg, params, _, _ = _golden()
    state = {k: v for k, v in jax_params_to_state_dict(params).items() if "score_embeddings" not in k}
    path = str(tmp_path / "no_scores.pt")
    torch.save(state, path)
    model = models_factory["stlt"](_port_config(cfg))
    with caplog.at_level(logging.WARNING):
        load_checkpoint(path, model)
    assert "loading with strict=False" in caplog.text
    key = "backbone.frames_embeddings.layer_norm.weight"
    np.testing.assert_array_equal(model.state_dict()[key].numpy(), state[key].numpy())


def test_load_checkpoint_reads_the_golden_msgpack(caplog):
    """The flax-written golden ``.msgpack`` loads with ``strict=True`` (no
    fallback warning) and reproduces the golden logits."""
    cfg, _, inputs, expected = _golden()
    model = models_factory["stlt"](_port_config(cfg)).eval()
    with caplog.at_level(logging.WARNING):
        load_checkpoint(os.path.join(DATA, "golden_stlt_params.msgpack"), model)
    assert "strict=False" not in caplog.text
    np.testing.assert_allclose(_port_logits(model, inputs), expected, atol=2e-5, rtol=1e-5)


def test_load_checkpoint_resamples_the_position_table(tmp_path):
    cfg, params, _, _ = _golden()
    state = jax_params_to_state_dict(params)
    path = str(tmp_path / "golden.pt")
    torch.save(state, path)
    model = models_factory["stlt"](_port_config(dataclasses.replace(cfg, layout_num_frames=45)))
    load_checkpoint(path, model)
    key = "backbone.frames_embeddings.position_embeddings.weight"
    want = jax_resize_position_table(state[key].numpy(), 45)
    np.testing.assert_allclose(model.state_dict()[key].numpy(), want, atol=1e-6)
    np.testing.assert_allclose(resize_position_table(state[key], 45).numpy(), want, atol=1e-6)
    assert tuple(model.state_dict()["backbone.frames_embeddings.position_ids"].shape) == (1, 45)


# --- (d) whole-model logits against the JAX package ----------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(dtype, ragged, use_pallas):
    params = _jax_params(dtype)
    cfg = JaxStltConfig(compute_dtype=dtype, use_pallas=use_pallas, **MODEL_KW)
    inputs = _inputs(ragged)
    want = np.asarray(jax_models["stlt"](cfg).apply({"params": params}, inputs)["stlt"])
    tfe.reset_launches()
    got = _port_logits(_port_model(cfg, params), inputs)
    assert tfe.LAUNCHES == dict.fromkeys(ALL_KERNELS, 0)
    assert got.shape == (4, MODEL_KW["num_classes"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOGITS_TOL[dtype])


def test_action_genome_scores_branch_matches_jax():
    params = _jax_params("float32", True)
    cfg = JaxStltConfig(**MODEL_KW)
    inputs = _inputs(True, with_scores=True)
    want = np.asarray(jax_models["stlt"](cfg).apply({"params": params}, inputs)["stlt"])
    got = _port_logits(_port_model(cfg, params), inputs)
    np.testing.assert_allclose(got, want, **LOGITS_TOL["float32"])
    without = _port_logits(_port_model(cfg, params), {k: v for k, v in inputs.items() if k != "scores"})
    assert np.abs(without - got).max() > 1e-3  # the scores do reach the logits


def test_logits_ignore_pad_frames():
    """Pad frames are dead rows: whatever their boxes hold, the logits do
    not move."""
    params = _jax_params("float32")
    model = _port_model(JaxStltConfig(**MODEL_KW), params)
    inputs = _inputs(True)
    noisy = {k: v.copy() for k, v in inputs.items()}
    pad = noisy["frame_types"] == 0
    assert pad.any()
    noisy["boxes"][pad] = np.random.default_rng(9).uniform(0, 1, noisy["boxes"][pad].shape)
    noisy["categories"][pad] = 2
    np.testing.assert_array_equal(_port_logits(model, noisy), _port_logits(model, inputs))


def test_too_many_frames_for_the_position_table_raises():
    params = _jax_params("float32")
    cfg = JaxStltConfig(**dict(MODEL_KW, layout_num_frames=32))
    model = _port_model(cfg, params)
    batch = _synthetic_layout_batch(2, 33, 8, 4, seed=0)
    with pytest.raises(ValueError, match="position table holds 32"):
        _port_logits(model, {k: v for k, v in batch.items() if k != "labels"})


def test_eval_only():
    """Only eval mode runs without a generator: train mode draws its dropout
    from an explicit torch.Generator and raises without one."""
    model = _port_model(JaxStltConfig(**MODEL_KW), _jax_params("float32"))
    assert np.isfinite(_port_logits(model, _inputs(False))).all()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        _port_logits(model.train(), _inputs(False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_is_the_gather_and_its_gradient_the_scatter_sum(dtype):
    """``models/stlt.embed`` (the category and frame-type tables' one-hot
    product) gives ``nn.functional.embedding``'s rows bit for bit, int32
    ids too, and the table's gradient is the per-row sum of the output
    gradient (f32 within 1e-5; bf16 within a bf16 step)."""
    from stlt_tpu_torch.models.stlt import embed

    gen = torch.Generator().manual_seed(5)
    table = torch.randn(5, 24, generator=gen).to(dtype).requires_grad_()
    ids = torch.randint(0, 5, (6, 17, 8), generator=gen)
    out = embed(ids.to(torch.int32), table)
    assert torch.equal(out, torch.nn.functional.embedding(ids, table))
    g = torch.randn(out.shape, generator=gen).to(dtype)
    (grad,) = torch.autograd.grad(out, table, g)
    want = torch.zeros(5, 24, dtype=torch.float64).index_add_(0, ids.reshape(-1),
                                                              g.reshape(-1, 24).double())
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert float((grad.double() - want).abs().max() / want.abs().max()) <= tol
