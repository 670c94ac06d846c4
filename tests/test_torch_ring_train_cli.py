"""``python -m stlt_tpu_torch.train --context_parallel 2 --num_processes 2
--platform cpu`` on two gloo ranks (``tests/ring_worker.py train_cli``)
against the one-process run, and the train CLI's refusals under the ring.

At a tiny width, dropout 0, one epoch of two AdamW steps and a validation
pass: each rank logs its backend line; only the coordinator (rank 0) writes
the checkpoint and the log file (each rank is given its own path, so a
write by rank 1 would show); the coordinator's ``.pt`` equals the one
process's at atol = rtol = 1e-5 (the same f32 function, with the frame axis
padded by one dead slot for the ring and sums taken in another order),
but for the key projection's bias (``KEY_BIAS_ATOL``).
"""

import json
import os

import pytest
import torch

from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.parser import build_parser
from tests.fixtures import make_something_fixture
from tests.test_torch_ring import _run_ranks


# The key projection's bias has a zero gradient in exact arithmetic (the
# softmax is invariant to a constant added to a query's logits), so both runs
# hand AdamW rounding noise, which its normalised step turns into moves of up
# to the learning rate: two steps of 1e-3.
KEY_BIAS_ATOL = 2e-3


def _argv(paths):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
        "--num_attention_heads", "4", "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--hidden_dropout_prob", "0", "--epochs", "1", "--learning_rate", "1e-3", "--platform", "cpu",
    ]


def test_train_on_two_ranks_writes_the_single_process_checkpoint(tmp_path):
    _check_two_ranks(tmp_path, [])


def test_train_with_remat_and_grad_accum_on_two_ranks_writes_the_single_process_checkpoint(
        tmp_path):
    """``--remat --grad_accum_steps 2`` under the ring: each rank's backward
    recomputes its layers (the ring forward's exchanges again, in the same
    order on both ranks), the two microbatches' gradients are summed over
    the ring once, after the second; the coordinator's checkpoint equals
    the one process's with the same levers."""
    _check_two_ranks(tmp_path, ["--remat", "--grad_accum_steps", "2"])


def _check_two_ranks(tmp_path, levers):
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8)
    single = port_train.main(_argv(paths) + levers + ["--save_model_path", str(tmp_path / "one.pt")])
    assert single.step == 2 and single.epochs[0]["is_best"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_argv(paths) + levers + ["--context_parallel", "2", "--num_processes", "2"], f)
    outs = _run_ranks("train_cli", tmp_path)
    with open(tmp_path / "log_0.txt") as f:
        logged = {0: f.read(), 1: outs[1]}
    for r in range(2):
        assert f"rank {r} of 2 on cpu, backend gloo" in logged[r], logged[r]
    assert "Epoch 1: train loss" in logged[0] and "Found new best on epoch 1" in logged[0]
    assert os.path.exists(tmp_path / "best_0.pt") and not os.path.exists(tmp_path / "best_1.pt")
    assert not os.path.exists(tmp_path / "log_1.txt")
    want = torch.load(tmp_path / "one.pt")
    got = torch.load(tmp_path / "best_0.pt")
    assert set(got) == set(want)
    for name, value in got.items():
        if name.endswith("self_attn.in_proj_bias"):  # its key third: see KEY_BIAS_ATOL
            H = value.shape[0] // 3
            torch.testing.assert_close(value[H:2 * H], want[name][H:2 * H], atol=KEY_BIAS_ATOL, rtol=0,
                                       msg=name)
            value, want[name] = value[[*range(H), *range(2 * H, 3 * H)]], \
                want[name][[*range(H), *range(2 * H, 3 * H)]]
        torch.testing.assert_close(value, want[name], atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--context_parallel", "2", "--num_processes", "2", "--model_name", "cacnf",
                  "--dataset_type", "multimodal"], None,
                 id="extra0-A9 \\(fusion models under the ring\\)"),
    pytest.param(["--context_parallel", "2", "--num_processes", "1"], None,
                 id="extra1-A9 \\(ranks per process\\)"),
    pytest.param(["--model_parallel", "2"], None, id="extra2-A9 \\(model axis\\)"),
    (["--model_parallel", "2", "--layout_num_frames", "256"], "A9 \\(model axis, long-clip training\\)"),
    (["--model_parallel", "2", "--context_parallel", "2"], "A9 \\(model axis, long-clip training\\)"),
])
def test_train_check_flags_refuses_what_waits_under_the_ring(extra, item):
    """What waits raises naming its item; the cases whose item is None
    waited for items that have landed and keep their ids: CACNF under the
    ring (A9, fusion models under the ring), a ring of two from one
    process (A9, ranks per process) and ``--model_parallel 2`` at 17
    frames (A9, model axis: its training half); the check now takes them.
    The model axis refuses the fused train tail's clips (256 frames on)
    and a ring beside it, which wait for A9 (model axis, long-clip
    training)."""
    args = build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
         "--save_model_path", "best.pt", *extra])
    if item is None:
        port_train.check_flags(args)
        return
    with pytest.raises(NotImplementedError, match=f"waits for ROADMAP.md item {item}"):
        port_train.check_flags(args)
