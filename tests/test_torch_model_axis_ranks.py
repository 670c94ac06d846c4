"""The port's model axis over gloo ranks on the CPU, against the JAX package.

Each rank is a subprocess of ``tests/ring_worker.py model_axis`` (torch and
the port only, a ``file://`` store under ``tmp_path``): the full weights
loaded as one process loads them, then cut to the rank's shards
(``parallel/sharding.shard_model_``), at ``tests/test_torch_ring_fusion.py``'s
tiny sizes (H 32, 4 heads, R3D depth 10, 8 layout frames), f32:

- (a) STLT on M = 2 model ranks against JAX's ``compile_steps`` eval step
  on ``make_mesh(model_parallel=2)`` (1e-5, JAX's own limit in
  ``tests/test_parallel.py``) and against the port's one process (1e-6);
  the ranks' logits equal bit for bit;
- (b) CACNF and LCF likewise, every head, as ``tests/test_parallel_fusion.py``
  holds JAX's on a model mesh (weights carried from a seeded port model:
  ``tests/test_torch_fusion.py::carried_params``);
- (c) STLT on a model 2 x context 2 grid (four ranks: the ring over each
  model rank's heads) against JAX's ``make_mesh(model_parallel=2,
  context_parallel=2)`` eval step and the port's one process;
- STLT on M = 4 ranks (one head a rank) against JAX, and at 72 layout
  frames (the temporal attention past the fused kernels' 64 tokens)
  against one process;
- STLT and CACNF at 512 layout frames on M = 2 ranks with no ring (the
  temporal attention and CACNF's cross-attention at 513 tokens, on the
  blockwise kernels) against one process.

The CLIs (``predict`` / ``inference --model_parallel 2`` from one process,
and a process that starts several ranks) are held in
``tests/test_torch_model_axis_cli.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_layout_batch
from stlt_tpu.configs import StltModelConfig as JaxStltConfig
from stlt_tpu.models import models_factory as jax_models
from stlt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from stlt_tpu.parallel.mesh import set_active_mesh as jax_set_active_mesh
from stlt_tpu.training.loop import compile_steps
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.ring_worker import run_fusion_case
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_fusion import KW, _inputs, fusion_batch, port_state

JAX_TOL = dict(atol=1e-5, rtol=1e-5)
ONE_PROCESS_TOL = dict(atol=1e-6, rtol=1e-6)
STLT_KW = dict(num_classes=KW["num_classes"], unique_categories=4, hidden_size=32, num_attention_heads=4,
               num_spatial_layers=1, num_temporal_layers=2, layout_num_frames=KW["layout_num_frames"])


def _jax_eval(model, params, batch, **mesh_kw):
    """JAX's eval step (every head) on a mesh of ``mesh_kw`` over the first
    devices, one compiled program."""
    jax_set_active_mesh(None)
    world = mesh_kw.get("model_parallel", 1) * mesh_kw.get("context_parallel", 1)
    mesh = jax_make_mesh(devices=jax.devices()[:world], **mesh_kw)
    try:
        steps = compile_steps(mesh, model, params_template=params, batch_template=batch)
        out = steps.eval_step(jax.device_put(params, steps.params_sharding), batch)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jax_set_active_mesh(None)


def _stlt(tmp_path):
    """A JAX STLT, its params and batch, and the port's case for them."""
    batch = {k: v for k, v in fusion_batch(11, (3, KW["layout_num_frames"])).items() if k != "video_frames"}
    model = jax_models["stlt"](JaxStltConfig(**STLT_KW))
    params = model.init(jax.random.PRNGKey(0), _inputs(batch))["params"]
    np.savez(tmp_path / "stlt_batch.npz", **batch)
    _save_state(tmp_path / "stlt.pt", jax_params_to_state_dict(params))
    case = {"model": "stlt", "config": STLT_KW, "state": "stlt.pt", "batch": "stlt_batch.npz",
            "kind": "eval"}
    return model, params, batch, case


def _save_state(path, state):
    torch.save(state, path)


def _check(label, tmp_path, world, one, want, heads):
    ranks = [np.load(tmp_path / f"{label}_{r}.npz") for r in range(world)]
    for head in heads:
        got = ranks[0][f"logits_{head}"]
        for r in range(1, world):
            np.testing.assert_array_equal(ranks[r][f"logits_{head}"], got, err_msg=f"{label} {head} rank {r}")
        np.testing.assert_allclose(got, want[head], **JAX_TOL, err_msg=f"{label} {head} against JAX")
        np.testing.assert_allclose(got, one[f"logits_{head}"], **ONE_PROCESS_TOL,
                                   err_msg=f"{label} {head} against one process")


def test_models_on_two_model_ranks_match_jax_and_one_process(tmp_path):
    """(a) STLT and (b) CACNF and LCF, every head, on M = 2 ranks."""
    stlt_model, stlt_params, stlt_batch, stlt_case = _stlt(tmp_path)
    cases, refs = {"stlt": stlt_case}, {"stlt": _jax_eval(stlt_model, stlt_params, stlt_batch, model_parallel=2)}
    batch = fusion_batch(12, (3, KW["layout_num_frames"]))
    np.savez(tmp_path / "fusion_batch.npz", **batch)
    for name in ("cacnf", "lcf"):
        model, params, state = port_state(name, 13, batch)
        _save_state(tmp_path / f"{name}.pt", state)
        cases[name] = {"model": name, "config": KW, "state": f"{name}.pt", "batch": "fusion_batch.npz",
                       "kind": "eval"}
        refs[name] = _jax_eval(model, params, batch, model_parallel=2)
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": 2, "context_parallel": 1, "cases": cases}, f)
    _run_ranks("model_axis", tmp_path, world=2)
    for label, case in cases.items():
        one = run_fusion_case(str(tmp_path), case)
        heads = [k[len("logits_"):] for k in one if k.startswith("logits_")]
        assert set(heads) == set(refs[label]), label
        _check(label, tmp_path, 2, one, refs[label], heads)


def test_stlt_on_a_model_by_context_grid_matches_jax_and_one_process(tmp_path):
    """(c) M = 2 x C = 2: four ranks, each ring over one model rank's heads."""
    model, params, batch, case = _stlt(tmp_path)
    want = _jax_eval(model, params, batch, model_parallel=2, context_parallel=2)
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": 2, "context_parallel": 2, "cases": {"stlt": case}}, f)
    _run_ranks("model_axis", tmp_path, world=4)
    _check("stlt", tmp_path, 4, run_fusion_case(str(tmp_path), case), want, ["stlt"])


@pytest.mark.parametrize("M", [4])
def test_stlt_on_four_model_ranks_matches_one_process(tmp_path, M):
    """M = 4: one head a rank, FF / 4 hidden units; and STLT at 72 layout
    frames (73 tokens: the temporal attention off the fused kernel, the
    out-projection a plain row-parallel product) against one process."""
    model, params, batch, case = _stlt(tmp_path)
    want = _jax_eval(model, params, batch, model_parallel=M)
    long_batch = dict(_synthetic_layout_batch(4, 72, 4, 4, seed=14, length_range=(40, 72)),
                      valid=np.ones(4, bool))
    np.savez(tmp_path / "long_batch.npz", **long_batch)
    long_cfg = dict(STLT_KW, layout_num_frames=72)
    _save_state(tmp_path / "long.pt", models_factory["stlt"](make_model_config("stlt", **long_cfg),
                                                            torch.Generator().manual_seed(15)).state_dict())
    long_case = dict(case, config=long_cfg, state="long.pt", batch="long_batch.npz")
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": M, "context_parallel": 1, "cases": {"stlt": case, "long": long_case}}, f)
    _run_ranks("model_axis", tmp_path, world=M)
    _check("stlt", tmp_path, M, run_fusion_case(str(tmp_path), case), want, ["stlt"])
    one = run_fusion_case(str(tmp_path), long_case)
    ranks = [np.load(tmp_path / f"long_{r}.npz")["logits_stlt"] for r in range(M)]
    for r in range(1, M):
        np.testing.assert_array_equal(ranks[r], ranks[0])
    np.testing.assert_allclose(ranks[0], one["logits_stlt"], **ONE_PROCESS_TOL)


def test_models_at_512_frames_on_two_model_ranks_match_one_process(tmp_path):
    """Serving at 512 layout frames without a ring: STLT's temporal
    attention and CACNF's layout self- and cross-attentions see 513 tokens
    and take the blockwise route, each rank on its heads with no dropout
    (so no head base); every head's logits equal across the ranks and
    within 1e-6 of one process. ``--layout_num_frames 512`` gives the
    model 513 frames, the extract slot included
    (``configs.position_table_rows``)."""
    frames = 513
    batch = dict(_synthetic_layout_batch(3, frames, 4, 4, seed=16, length_range=(300, frames)),
                 valid=np.ones(3, bool))
    batch["video_frames"] = np.random.default_rng(17).standard_normal((3, 4, 64, 64, 3)).astype(np.float32)
    np.savez(tmp_path / "long_batch.npz", **batch)
    cases = {}
    for seed, (name, cfg) in enumerate((("stlt", dict(STLT_KW, layout_num_frames=frames)),
                                        ("cacnf", dict(KW, layout_num_frames=frames))), start=18):
        _save_state(tmp_path / f"{name}.pt", models_factory[name](make_model_config(name, **cfg),
                                                                  torch.Generator().manual_seed(seed)).state_dict())
        cases[name] = {"model": name, "config": cfg, "state": f"{name}.pt", "batch": "long_batch.npz",
                       "kind": "eval"}
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": 2, "context_parallel": 1, "cases": cases}, f)
    _run_ranks("model_axis", tmp_path, world=2)
    for label, case in cases.items():
        one = run_fusion_case(str(tmp_path), case)
        heads = [k for k in one if k.startswith("logits_")]
        assert heads, label
        ranks = [np.load(tmp_path / f"{label}_{r}.npz") for r in range(2)]
        for head in heads:
            np.testing.assert_array_equal(ranks[1][head], ranks[0][head], err_msg=f"{label} {head}")
            np.testing.assert_allclose(ranks[0][head], one[head], **ONE_PROCESS_TOL, err_msg=f"{label} {head}")
