"""Every factory model over the data axis on two gloo ranks, on the CPU
(``tests/ring_worker.py``), at the multimodal serving tests' geometry
(``tests/test_torch_multimodal.py``: 4 frames of 64 px, R3D depth 10, a
fabricated HDF5 archive of five clips, batches of 2):

- ``predict --num_processes 2`` of ``resnet3d`` and ``resnet3d-transformer``
  (``--dataset_type appearance``), LCF, CAF and CACNF (``multimodal``) under
  one process group writes the one process's clips in its order with its
  top-k (scores at ``SCORE_ATOL``, ids wherever the scores are not tied
  within it: the CPU's R3D convolutions take other sums for one clip than
  for two; STLT, bit for bit: ``tests/test_torch_data_axis_ranks.py``); the
  third global batch holds one clip, so rank 1 serves padding alone;
- ``train --num_processes 2`` of CACNF at dropout 0.1 (three steps of one
  clip a rank, the last rank 1's padding alone: its loss divides by the
  global batch's one valid row) against one process: the epoch loss within
  1e-5 and the coordinator's checkpoint within 1e-5 (the key projections'
  biases within ``KEY_BIAS_ATOL``, as in
  ``tests/test_torch_ring_train_cli.py``), the coordinator alone writing it.
"""

import json
import os
import re

import numpy as np
import torch

from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.test_torch_multimodal import SCORE_ATOL, _appearance_argv, _argv, _random_checkpoint
from tests.test_torch_ring import _run_ranks
from tests.test_torch_ring_train_cli import KEY_BIAS_ATOL

SERVED = ("resnet3d", "resnet3d-transformer", "lcf", "caf", "cacnf")


def _fixture(root):
    paths, _, labels, sizes = make_something_fixture(root, num_videos=5)
    return paths, labels, make_video_hdf5(root, sizes, num_frames=10)


def _serving_argv(root, paths, videos, checkpoints, name):
    argv = _argv(root, paths, videos, name, checkpoints[name], "--platform", "cpu")
    return _appearance_argv(argv) if name.startswith("resnet3d") else argv


def test_every_model_serves_on_two_data_ranks(tmp_path):
    root = str(tmp_path)
    paths, labels, videos = _fixture(root)
    checkpoints = {name: _random_checkpoint(root, name, len(labels)) for name in SERVED}
    runs = [_serving_argv(root, paths, videos, checkpoints, name)
            + ["--output", os.path.join(root, f"{name}_two.jsonl")] for name in SERVED]
    with open(tmp_path / "models.json", "w") as f:
        json.dump(runs, f)
    outs = _run_ranks("predict_models", tmp_path)
    for r, out in enumerate(outs):
        assert f"rank {r} of 2 on cpu, backend gloo" in out, out
    for name in SERVED:
        one = os.path.join(root, f"{name}_one.jsonl")
        port_predict.main(_serving_argv(root, paths, videos, checkpoints, name) + ["--output", one])
        with open(one) as f, open(os.path.join(root, f"{name}_two.jsonl")) as g:
            want, got = [json.loads(line) for line in f], [json.loads(line) for line in g]
        assert len(want) == len(got) == 5, name
        for w, o in zip(want, got):
            assert o["video_id"] == w["video_id"], name
            scores = np.array([t["score"] for t in w["top_k"]])
            np.testing.assert_allclose([t["score"] for t in o["top_k"]], scores, atol=SCORE_ATOL,
                                       err_msg=name)
            for j, score in enumerate(scores):
                if np.all(np.abs(np.delete(scores, j) - score) > 2 * SCORE_ATOL):
                    assert o["top_k"][j]["label_id"] == w["top_k"][j]["label_id"], name


def _train_argv(root, paths, videos, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", "cacnf",
        "--train_dataset_path", paths["dataset_path"], "--val_dataset_path", paths["dataset_path"],
        "--labels_path", paths["labels_path"], "--videoid2size_path", paths["videoid2size_path"],
        "--videos_path", videos, "--layout_num_frames", "4", "--appearance_num_frames", "4",
        "--spatial_size", "64", "--batch_size", "2", "--epochs", "1", "--warmup_epochs", "1",
        "--learning_rate", "1e-3", "--hidden_size", "32", "--num_attention_heads", "4",
        "--num_spatial_layers", "1", "--num_temporal_layers", "1", "--num_appearance_layers", "1",
        "--num_fusion_layers", "1", "--resnet_depth", "10", "--platform", "cpu", *extra,
    ]


def test_cacnf_trains_on_two_data_ranks_as_one_process(tmp_path):
    root = str(tmp_path)
    paths, _, videos = _fixture(root)
    single = port_train.main(_train_argv(root, paths, videos, "--save_model_path",
                                         os.path.join(root, "one.pt")))
    assert single.step == 3
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(_train_argv(root, paths, videos, "--num_processes", "2"), f)
    outs = _run_ranks("train_cli", tmp_path)
    with open(tmp_path / "log_0.txt") as f:
        logged = f.read()
    assert "rank 0 of 2 on cpu, backend gloo" in logged and "rank 1 of 2 on cpu" in outs[1]
    loss = float(re.search(r"Epoch 1: train loss ([0-9.]+)", logged).group(1))
    assert abs(loss - single.epochs[0]["train_loss"]) < 1e-5
    assert single.epochs[0]["is_best"]
    assert os.path.exists(tmp_path / "best_0.pt") and not os.path.exists(tmp_path / "best_1.pt")
    want, got = torch.load(os.path.join(root, "one.pt")), torch.load(tmp_path / "best_0.pt")
    assert set(got) == set(want)
    for name, value in got.items():
        if name.endswith("in_proj_bias"):  # the key third: see KEY_BIAS_ATOL
            H = value.shape[0] // 3
            torch.testing.assert_close(value[H:2 * H], want[name][H:2 * H], atol=KEY_BIAS_ATOL,
                                       rtol=0, msg=name)
            value, want[name] = torch.cat([value[:H], value[2 * H:]]), \
                torch.cat([want[name][:H], want[name][2 * H:]])
        torch.testing.assert_close(value, want[name], atol=1e-5, rtol=1e-5, msg=name)
