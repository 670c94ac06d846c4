"""The rest of the factory models on the port's model axis, over gloo ranks
on the CPU, against the JAX package (as ``tests/test_torch_model_axis_ranks.py``
holds STLT, CACNF and LCF; same sizes, f32):

- CAF, ``resnet3d`` and ``resnet3d-transformer`` on M = 2 model ranks
  against JAX's ``compile_steps`` eval step on ``make_mesh(model_parallel=2)``
  (1e-5) and the port's one process (1e-6), the ranks' logits bit for bit
  (``resnet3d`` has nothing to shard: its ranks run it whole);
- CACNF on a model 2 x context 2 grid (four ranks: the layout branch's
  ring over each model rank's heads, the gathered stream, the appearance
  branch, the fusion blocks and every head on the model ranks' shards)
  against JAX's ``make_mesh(model_parallel=2, context_parallel=2)``.
"""

import json

import numpy as np

from tests.ring_worker import run_fusion_case
from tests.test_torch_model_axis_ranks import _check, _jax_eval, _save_state
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_fusion import KW, fusion_batch, port_state


def _cases(tmp_path, names, seed, **mesh_kw):
    batch = fusion_batch(seed, (3, KW["layout_num_frames"]))
    np.savez(tmp_path / "batch.npz", **batch)
    cases, refs = {}, {}
    for name in names:
        model, params, state = port_state(name, seed + 1, batch)
        _save_state(tmp_path / f"{name}.pt", state)
        cases[name] = {"model": name, "config": KW, "state": f"{name}.pt", "batch": "batch.npz",
                       "kind": "eval"}
        refs[name] = _jax_eval(model, params, batch, **mesh_kw)
    with open(tmp_path / "model_axis.json", "w") as f:
        json.dump({"model_parallel": mesh_kw["model_parallel"],
                   "context_parallel": mesh_kw.get("context_parallel", 1), "cases": cases}, f)
    return cases, refs


def _run_and_check(tmp_path, cases, refs, world):
    _run_ranks("model_axis", tmp_path, world=world)
    for label, case in cases.items():
        one = run_fusion_case(str(tmp_path), case)
        heads = [k[len("logits_"):] for k in one if k.startswith("logits_")]
        assert set(heads) == set(refs[label]), label
        _check(label, tmp_path, world, one, refs[label], heads)


def test_caf_and_the_r3d_models_on_two_model_ranks_match_jax_and_one_process(tmp_path):
    cases, refs = _cases(tmp_path, ("caf", "resnet3d", "resnet3d-transformer"), 21, model_parallel=2)
    _run_and_check(tmp_path, cases, refs, 2)


def test_cacnf_on_a_model_by_context_grid_matches_jax_and_one_process(tmp_path):
    cases, refs = _cases(tmp_path, ("cacnf",), 31, model_parallel=2, context_parallel=2)
    _run_and_check(tmp_path, cases, refs, 4)
