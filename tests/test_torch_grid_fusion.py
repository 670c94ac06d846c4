"""CACNF on a data x context grid (D = 2 rings of C = 2 ranks), on the CPU.

Four gloo ranks, each a subprocess of ``tests/ring_worker.py`` (torch and
the port only), rank g at (data g // 2, context g % 2), at
``tests/test_torch_ring_fusion.py``'s sizes and batches:

- one CACNF step at dropout 0.1 (the appearance encoder's too; the layout
  branch's temporal attention, the one site on the ring, at 0 on both
  sides: see ``tests/test_torch_ring_fusion.py``) on the grid against the
  port's one process on the global batch: each ring's train-mode logits of
  its rows atol 1e-6, the gradients (the layout branch's summed over the
  ring, then every one over the data group) atol 1e-5, the four ranks'
  gradients bit for bit;
- two AdamW steps at dropout 0.1: the four ranks' weights and losses
  equal bit for bit;
- ``predict --num_processes 4 --context_parallel 2 --platform cpu`` of
  CACNF on ``tests/fixtures.py``'s multimodal fixture with an odd layout
  frame axis (4 layout frames and the extract frame: 5 slots, padded to 6
  on the ring) against one process: the same clips in the same order,
  identical top-k, scores atol 1e-5 (``tests/test_torch_multimodal.py``'s
  ``SCORE_ATOL``).
"""

import json
import os

import numpy as np
import pytest
import torch

from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.ring_worker import run_fusion_case
from tests.test_torch_multimodal import SCORE_ATOL, _argv, _random_checkpoint
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_fusion import (KW, ONE_PROCESS_GRAD_ATOL, ONE_PROCESS_LOGITS_ATOL,
                                          fusion_batch)
from tests.test_torch_train import TRAIN_HP

WORLD, C = 4, 2


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """The step and the two AdamW steps on the grid (one launch of each
    rank) and the step in one process."""
    root = tmp_path_factory.mktemp("grid_fusion")
    np.savez(root / "step.npz", **fusion_batch(7, (3, KW["layout_num_frames"])))
    model = models_factory["cacnf"](make_model_config("cacnf", **KW), torch.Generator().manual_seed(21))
    torch.save(model.state_dict(), root / "cacnf.pt")
    dropout = dict(KW, hidden_dropout_prob=0.1)
    train_hp = {k: TRAIN_HP[k] for k in ("lr", "weight_decay", "clip_val", "warmup", "total")}
    cases = {
        "step": dict(kind="step", model="cacnf", config=dropout, state="cacnf.pt", batch="step.npz",
                     quiet_ring_attention=True),
        "train": dict(kind="train", model="cacnf", config=dropout, state="cacnf.pt",
                      batch="step.npz", steps=2, hp=train_hp),
    }
    with open(root / "fusion.json", "w") as f:
        json.dump(cases, f)
    _run_ranks("fusion", root, world=WORLD)
    ranks = {label: [dict(np.load(root / f"{label}_{r}.npz")) for r in range(WORLD)] for label in cases}
    return ranks, run_fusion_case(root, cases["step"])


def test_grid_cacnf_dropout_step_is_the_one_process_step(grid_run):
    ranks, want = grid_run
    steps = ranks["step"]
    for r in range(1, WORLD):
        for key in (k for k in steps[0] if not k.startswith("logits_")):
            np.testing.assert_array_equal(steps[r][key], steps[0][key], err_msg=f"rank {r}: {key}")
    for d in range(WORLD // C):  # each ring's two ranks: the same logits of the ring's rows
        for key in (k for k in steps[0] if k.startswith("logits_")):
            np.testing.assert_array_equal(steps[d * C + 1][key], steps[d * C][key])
    for key in (k for k in want if k.startswith("logits_")):
        got = np.concatenate([steps[d * C][key] for d in range(WORLD // C)])
        np.testing.assert_allclose(got, want[key], atol=ONE_PROCESS_LOGITS_ATOL, rtol=0,
                                   err_msg=f"the rings' {key} at dropout 0.1")
    np.testing.assert_allclose(steps[0]["loss"], want["loss"], atol=ONE_PROCESS_LOGITS_ATOL, rtol=0)
    grads = sorted(k for k in want if k.startswith("grad_"))
    assert grads == sorted(k for k in steps[0] if k.startswith("grad_"))
    for part in ("layout_branch.", "appearance_branch.", "mm_fusion.", "classifier."):
        assert any(part in k for k in grads), part
    for key in grads:
        np.testing.assert_allclose(steps[0][key], want[key], atol=ONE_PROCESS_GRAD_ATOL, rtol=0,
                                   err_msg=f"{key} at dropout 0.1")


def test_grid_cacnf_ranks_stay_equal_after_two_adamw_steps(grid_run):
    ranks, _ = grid_run
    train = ranks["train"]
    assert np.isfinite(train[0]["losses"]).all()
    for r in range(1, WORLD):
        for key in train[0]:
            np.testing.assert_array_equal(train[r][key], train[0][key], err_msg=f"rank {r}: {key}")
    assert not np.array_equal(train[0]["params_0"], train[0]["params_1"])


def test_predict_cacnf_on_the_grid_writes_the_single_process_output(tmp_path):
    root = str(tmp_path)
    paths, _, labels, sizes = make_something_fixture(root, num_videos=5)
    videos = make_video_hdf5(root, sizes, num_frames=10)
    common = _argv(root, paths, videos, "cacnf", _random_checkpoint(root, "cacnf", len(labels)),
                   "--platform", "cpu")
    single = port_predict.main(common + ["--output", os.path.join(root, "one.jsonl")])
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(common + ["--output", os.path.join(root, "grid.jsonl"), "--context_parallel",
                            str(C), "--num_processes", str(WORLD)], f)
    outs = _run_ranks("predict", tmp_path, world=WORLD)
    for r, out in enumerate(outs):
        assert f"rank {r} of {WORLD} on cpu, backend gloo" in out, out
    with open(tmp_path / "grid.jsonl") as f:
        grid = [json.loads(line) for line in f]
    assert len(grid) == len(single) == 5
    for a, b in zip(grid, single):
        assert a["video_id"] == b["video_id"]
        assert [t["label_id"] for t in a["top_k"]] == [t["label_id"] for t in b["top_k"]]
        np.testing.assert_allclose([t["score"] for t in a["top_k"]], [t["score"] for t in b["top_k"]],
                                   atol=SCORE_ATOL)
