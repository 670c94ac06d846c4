"""The serving CLIs under ``--model_parallel``, and a process that starts
several ranks (``parallel/distributed.run_ranks``), on the CPU.

- (d) ``predict --model_parallel 2 --platform cpu`` run as one process (it
  starts both model ranks itself) writes the one process's JSON lines (the
  same clips and top-k labels, the scores within 1e-6), and ``inference
  --model_parallel 2`` returns the one process's metrics; four processes
  of D = 2 replicas of M = 2 model ranks write them too (the models
  themselves are held against JAX in ``tests/test_torch_model_axis_ranks.py``);
- (e) ranks per process: ``predict`` and ``train`` with
  ``--context_parallel 2 --num_processes 1`` (one process starting the
  ring's two ranks) equal ``--num_processes 2`` (two processes started one
  by one, ``tests/ring_worker.py``), bit for bit: the same JSON bytes, the
  same checkpoint tensors; a rank's non-zero exit fails the run with its
  code;
- (f) ``train --model_parallel 2`` from one process: full checkpoints (the
  best ``.msgpack``, the step checkpoints with AdamW's moments) equal to
  one process's, loading strict into one process, and a resumed run's
  checkpoint bit for bit.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from stlt_tpu_torch import inference as port_inference
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.data import datasets_factory
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parallel import distributed
from stlt_tpu_torch.parser import build_parser
from tests.fixtures import make_something_fixture
from tests.ring_worker import exit_on_rank
from tests.test_torch_ring import _run_ranks
from stlt_tpu_torch.utils.convert import read_state_dict
from tests.test_torch_ring_train_cli import KEY_BIAS_ATOL
from tests.test_torch_ring_train_cli import _argv as train_argv


def _serving(paths, *extra):
    return ["--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
            "--videoid2size_path", paths["videoid2size_path"], "--layout_num_frames", "8",
            "--batch_size", "4", "--hidden_size", "64", "--num_attention_heads", "4",
            "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--platform", "cpu", *extra]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A layout set of 6 clips and a seeded STLT checkpoint for it."""
    root = tmp_path_factory.mktemp("served")
    paths, *_ = make_something_fixture(str(root), num_videos=6)
    args = build_parser("test").parse_args(_serving(paths))
    data_cfg = port_predict.build_data_config(args, train=False, dataset_path=paths["dataset_path"])
    dataset = datasets_factory["layout"](data_cfg)
    model = models_factory["stlt"](port_predict.build_model_config(args, dataset, data_cfg),
                                   torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), root / "best.pt")
    return root, paths, ["--checkpoint_path", str(root / "best.pt")]


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_predict_model_parallel_from_one_process_writes_the_one_process_lines(served):
    """(d) predict."""
    root, paths, ckpt = served
    one = root / "one.jsonl"
    port_predict.main(_serving(paths, *ckpt, "--output", str(one)))
    two = root / "model2.jsonl"
    rows = port_predict.main(_serving(paths, *ckpt, "--model_parallel", "2", "--output", str(two)))
    want, got = _lines(one), _lines(two)
    assert len(got) == len(want) == len(rows) == 6
    for a, b in zip(got, want):
        assert a["video_id"] == b["video_id"]
        assert [t["label_id"] for t in a["top_k"]] == [t["label_id"] for t in b["top_k"]]
        np.testing.assert_allclose([t["score"] for t in a["top_k"]], [t["score"] for t in b["top_k"]],
                                   atol=1e-6, rtol=0)


def test_predict_on_a_data_by_model_grid_writes_the_one_process_lines(served, tmp_path):
    """(d) D = 2 replicas of M = 2 model ranks, four processes started one by
    one: each replica serves its rows of every batch, the rows gathered
    over the data group (the ranks of one model index)."""
    root, paths, ckpt = served
    one = tmp_path / "one.jsonl"
    port_predict.main(_serving(paths, *ckpt, "--output", str(one)))
    grid = tmp_path / "grid.jsonl"
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_serving(paths, *ckpt, "--model_parallel", "2", "--num_processes", "4",
                           "--output", str(grid)), f)
    _run_ranks("predict", tmp_path, world=4)
    want, got = _lines(one), _lines(grid)
    assert [r["video_id"] for r in got] == [r["video_id"] for r in want]
    for a, b in zip(got, want):
        assert [t["label_id"] for t in a["top_k"]] == [t["label_id"] for t in b["top_k"]]
        np.testing.assert_allclose([t["score"] for t in a["top_k"]], [t["score"] for t in b["top_k"]],
                                   atol=1e-6, rtol=0)


def test_inference_model_parallel_returns_the_one_process_metrics(served):
    """(d) inference: the coordinator's metrics, through the file the
    launcher passes back."""
    root, paths, ckpt = served
    one = port_inference.main(_serving(paths, *ckpt))
    two = port_inference.main(_serving(paths, *ckpt, "--model_parallel", "2"))
    assert set(one) == set(two) and one
    for key in one:
        assert two[key] == pytest.approx(one[key], abs=1e-12), key


def test_predict_ranks_per_process_equal_ranks_started_one_by_one(served, tmp_path):
    """(e) predict: ``--context_parallel 2 --num_processes 1`` against two
    processes of one rank each: the same bytes."""
    root, paths, ckpt = served
    spawned = tmp_path / "spawned.jsonl"
    port_predict.main(_serving(paths, *ckpt, "--context_parallel", "2", "--num_processes", "1",
                               "--output", str(spawned)))
    by_hand = tmp_path / "by_hand.jsonl"
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_serving(paths, *ckpt, "--context_parallel", "2", "--num_processes", "2",
                           "--output", str(by_hand)), f)
    _run_ranks("predict", tmp_path)
    assert spawned.read_bytes() == by_hand.read_bytes()
    assert len(_lines(spawned)) == 6


def test_train_ranks_per_process_equal_ranks_started_one_by_one(tmp_path):
    """(e) train: the coordinator's checkpoint of ``--context_parallel 2
    --num_processes 1`` equals that of two processes started one by one,
    tensor for tensor, bit for bit; the launcher returns the first rank's
    epoch records, its model left in the rank's process."""
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8)
    ring = ["--context_parallel", "2"]
    result = port_train.main(train_argv(paths) + ring + ["--num_processes", "1", "--save_model_path",
                                                         str(tmp_path / "spawned.pt")])
    assert result.step == 2 and result.model is None and result.epochs[0]["is_best"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(train_argv(paths) + ring + ["--num_processes", "2"], f)
    _run_ranks("train_cli", tmp_path)
    want, got = torch.load(tmp_path / "best_0.pt"), torch.load(tmp_path / "spawned.pt")
    assert set(got) == set(want)
    for name, value in got.items():
        assert torch.equal(value, want[name]), name


def test_a_rank_that_fails_fails_the_run():
    """A spawned rank's non-zero exit: the launcher stops the others and
    exits with its code."""
    args = build_parser("test").parse_args(["--context_parallel", "2", "--platform", "cpu"])
    assert distributed.ranks_per_process(args) == 2
    with pytest.raises(SystemExit) as raised:
        distributed.run_ranks(args, exit_on_rank)
    assert raised.value.code == 3


def test_ranks_per_process_follow_the_flags():
    def parse(*flags):
        return build_parser("test").parse_args(list(flags))

    assert distributed.ranks_per_process(parse("--model_parallel", "2", "--context_parallel", "2")) == 4
    assert distributed.ranks_per_process(parse("--model_parallel", "2", "--context_parallel", "2",
                                               "--num_processes", "2")) == 2
    assert distributed.ranks_per_process(parse("--context_parallel", "2", "--num_processes", "4")) == 1
    assert distributed.data_size(parse("--context_parallel", "2", "--num_processes", "4")) == 2
    assert distributed.data_size(parse("--model_parallel", "4", "--num_processes", "2")) == 1
    with pytest.raises(ValueError, match="--num_processes 3 does not divide the replica's 4 ranks"):
        distributed.ranks_per_process(parse("--model_parallel", "4", "--num_processes", "3"))


def _state_close(got, want, label):
    """Two state dicts of one f32 STLT trained the same way, up to the order
    of sums (the key third of ``in_proj_bias``: ``KEY_BIAS_ATOL``)."""
    assert set(got) == set(want), label
    for name, value in got.items():
        ref = want[name]
        if name.endswith("self_attn.in_proj_bias"):
            H = value.shape[0] // 3
            torch.testing.assert_close(value[H:2 * H], ref[H:2 * H], atol=KEY_BIAS_ATOL, rtol=0,
                                       msg=f"{label} {name}")
            value, ref = value[[*range(H), *range(2 * H, 3 * H)]], ref[[*range(H), *range(2 * H, 3 * H)]]
        torch.testing.assert_close(value, ref, atol=1e-5, rtol=1e-5, msg=f"{label} {name}")


def test_train_model_parallel_writes_full_checkpoints_and_resumes_bit_for_bit(tmp_path):
    """(f) ``train --model_parallel 2`` from one process (dropout 0.1, two
    epochs, ``--resume_dir``): the best ``.msgpack`` and each step
    checkpoint hold full tensors that load strict into one process and
    equal one process's run (its AdamW moments too); a run resumed from the
    first step checkpoint writes the second one bit for bit."""
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=8)
    argv = train_argv(paths) + ["--epochs", "2", "--hidden_dropout_prob", "0.1"]
    runs = {}
    for label, extra in (("one", []), ("model", ["--model_parallel", "2"])):
        port_train.main(argv + extra + ["--save_model_path", str(tmp_path / f"{label}.msgpack"),
                                        "--resume_dir", str(tmp_path / label)])
        runs[label] = [torch.load(tmp_path / label / f"step_{s:09d}.pt", weights_only=True) for s in (2, 4)]
    one, two = runs["one"], runs["model"]
    args = build_parser("test").parse_args(argv)
    data_cfg = port_predict.build_data_config(args, train=False, dataset_path=paths["dataset_path"])
    model = models_factory["stlt"](port_predict.build_model_config(args, datasets_factory["layout"](data_cfg),
                                                                   data_cfg))  # one process's
    for s, (a, b) in enumerate(zip(one, two)):
        model.load_state_dict(b["model"], strict=True)
        _state_close(b["model"], a["model"], f"step checkpoint {s}")
        assert b["step"] == a["step"] and b["epoch"] == a["epoch"]
        for idx, entry in a["optimizer"]["state"].items():
            for key, value in entry.items():
                got = b["optimizer"]["state"][idx][key]
                assert got.shape == value.shape, (idx, key)
                torch.testing.assert_close(got, value, atol=1e-8, rtol=1e-5, msg=f"{s} {idx} {key}")
    best = {label: read_state_dict(str(tmp_path / f"{label}.msgpack"), model) for label in runs}
    model.load_state_dict(best["model"], strict=True)
    _state_close(best["model"], best["one"], "best .msgpack")

    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copy(tmp_path / "model" / "step_000000002.pt", resumed / "step_000000002.pt")
    port_train.main(argv + ["--model_parallel", "2", "--save_model_path", str(tmp_path / "resumed.msgpack"),
                            "--resume_dir", str(resumed)])
    again = torch.load(resumed / "step_000000004.pt", weights_only=True)
    for name, value in two[1]["model"].items():
        assert torch.equal(again["model"][name], value), name
    for idx, entry in two[1]["optimizer"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(again["optimizer"]["state"][idx][key], value), (idx, key)
