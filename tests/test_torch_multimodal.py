"""The port's multimodal serving CLIs on the CPU against the JAX package's:
``python -m stlt_tpu_torch.predict`` and ``python -m stlt_tpu_torch.inference``
with ``--dataset_type multimodal`` for CACNF and LCF (and ``predict`` with
``--dataset_type appearance`` for ``resnet3d-transformer``), on a fabricated
HDF5 archive of JPEG frames (``tests/fixtures.make_video_hdf5``), and the
serving flag checks.

Both CLIs read the same reference-format ``.pt`` checkpoint (a randomly
initialised port model, with its frozen BN statistics and CLS/pos tables
drawn), at the multimodal drive's geometry: 4 frames of 64 px through R3D
depth 10 give 1 x 2 x 2 = 4 appearance tokens. Tolerances: scores are
softmax probabilities of f32 logits, atol 1e-5 (``tests/test_torch_predict.py``);
top-k ids agree wherever the scores are not tied within that; metrics are
counts of hits over the same clips, atol 1e-9.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from stlt_tpu.parser import build_parser as jax_build_parser
from stlt_tpu_torch import inference as port_inference
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch.configs import make_model_config
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.parser import build_parser
from tests.fixtures import make_something_fixture, make_video_hdf5

SCORE_ATOL = 1e-5
FRAMES, SPATIAL = 4, 64


def _argv(root, paths, videos, model_name, checkpoint, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", model_name,
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"], "--videos_path", videos,
        "--checkpoint_path", checkpoint, "--layout_num_frames", "4",
        "--appearance_num_frames", str(FRAMES), "--spatial_size", str(SPATIAL),
        "--batch_size", "2", "--hidden_size", "32", "--num_attention_heads", "4",
        "--num_spatial_layers", "1", "--num_temporal_layers", "1",
        "--num_appearance_layers", "1", "--num_fusion_layers", "1", "--resnet_depth", "10",
        *extra,
    ]


def _appearance_argv(argv):
    """The same flags on the appearance dataset (RGB frames only)."""
    argv = list(argv)
    argv[argv.index("--dataset_type") + 1] = "appearance"
    return argv


def _random_checkpoint(root, model_name, num_classes):
    cfg = make_model_config(
        model_name, num_classes=num_classes, unique_categories=4, hidden_size=32,
        num_attention_heads=4, num_spatial_layers=1, num_temporal_layers=1,
        num_appearance_layers=1, num_fusion_layers=1, resnet_depth=10,
        appearance_num_frames=FRAMES, layout_num_frames=256,
    )
    model = models_factory[model_name](cfg, torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    state = model.state_dict()
    for key, value in state.items():
        if key.endswith("running_mean"):
            value.normal_(0.0, 0.1, generator=gen)
        elif key.endswith("running_var"):
            value.uniform_(0.5, 1.5, generator=gen)
        elif key.endswith(("cls_token", "pos_embed")):
            value.normal_(0.0, 0.02, generator=gen)
    path = os.path.join(root, f"{model_name}.pt")
    torch.save(state, path)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_multimodal"))
    paths, _, labels, sizes = make_something_fixture(root, num_videos=5)
    videos = make_video_hdf5(root, sizes, num_frames=10)
    checkpoints = {name: _random_checkpoint(root, name, len(labels))
                   for name in ("cacnf", "lcf", "resnet3d-transformer")}
    return root, paths, videos, checkpoints


@pytest.mark.parametrize("model_name", ["cacnf", "lcf", "resnet3d-transformer"])
def test_multimodal_predict_cli_matches_jax_predict(served, tmp_path, model_name):
    """CACNF and LCF on the multimodal dataset, the appearance model on the
    appearance dataset."""
    from stlt_tpu.predict import predict as jax_predict

    root, paths, videos, checkpoints = served
    argv = _argv(root, paths, videos, model_name, checkpoints[model_name], "--platform", "cpu")
    if model_name == "resnet3d-transformer":
        argv = _appearance_argv(argv)
    out = str(tmp_path / "port.jsonl")
    rows = port_predict.main(argv + ["--output", out, "--top_k", "3"])
    jax_args = jax_build_parser("test").parse_args(argv)
    jax_args.top_k, jax_args.output = 3, str(tmp_path / "jax.jsonl")
    want = jax_predict(jax_args)

    with open(out) as f:
        assert [json.loads(line) for line in f] == rows
    assert len(rows) == len(want) == 5
    for got_row, want_row in zip(rows, want):
        assert got_row["video_id"] == want_row["video_id"]
        got_scores = np.array([t["score"] for t in got_row["top_k"]])
        want_scores = np.array([t["score"] for t in want_row["top_k"]])
        np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_ATOL)
        for j, score in enumerate(want_scores):
            if np.all(np.abs(np.delete(want_scores, j) - score) > 2 * SCORE_ATOL):
                assert got_row["top_k"][j]["label_id"] == want_row["top_k"][j]["label_id"]


@pytest.mark.parametrize("model_name", ["cacnf", "lcf"])
def test_multimodal_inference_cli_matches_jax_inference(served, model_name, caplog):
    from stlt_tpu.inference import inference as jax_inference

    root, paths, videos, checkpoints = served
    argv = _argv(root, paths, videos, model_name, checkpoints[model_name], "--platform", "cpu")
    with caplog.at_level(logging.WARNING):
        got = port_inference.main(argv)
    assert "loading with strict=False" not in caplog.text
    want = jax_inference(jax_build_parser("test").parse_args(argv))
    heads = models_factory[model_name].logit_names
    assert set(got) == set(want) == {f"{h}_{k}" for h in heads for k in ("top1_accuracy", "top5_accuracy")}
    for key in want:
        assert abs(got[key] - float(want[key])) < 1e-9, key


def _serving_args(*extra):
    return build_parser("test").parse_args(
        ["--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", "cacnf",
         *extra])


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--model_parallel", "2"], None, id="extra0-A9"),
    pytest.param(["--context_parallel", "2"], None, id="extra1-A9"),
    pytest.param(["--model_parallel", "2", "--num_processes", "2"], None, id="extra2-A9"),
    pytest.param(["--context_parallel", "2", "--num_processes", "4"], None, id="extra3-A9"),
    pytest.param(["--native_decode"], None, id="extra4-A10"),
])
def test_predict_check_flags_refuses_later_slices(extra, item):
    """The serving CLIs refuse the flags of later slices, naming the ROADMAP
    item, instead of running them silently on one device (ROADMAP.md C 2).
    The cases whose item is None waited for items that have landed and keep
    their ids: CACNF on a grid of two rings of two ranks (A9, fusion models
    under the ring), ``--native_decode`` (A10), and ``--model_parallel 2``
    and ``--context_parallel 2`` from one process (A9 (model axis) and A9
    (ranks per process)); the check now takes them."""
    if item is None:
        port_predict.check_flags(_serving_args(*extra))
        return
    with pytest.raises(NotImplementedError, match=f"waits for ROADMAP.md item {item}"):
        port_predict.check_flags(_serving_args(*extra))


@pytest.mark.parametrize("model_name", sorted(models_factory))
def test_predict_check_flags_takes_every_factory_model(model_name):
    port_predict.check_flags(_serving_args("--model_name", model_name))


def test_predict_check_flags_names_the_choices():
    with pytest.raises(ValueError, match="--model_name 'r2plus1d' is not one of"):
        port_predict.check_flags(_serving_args("--model_name", "r2plus1d"))
    with pytest.raises(ValueError, match="--dataset_type 'native' is not one of"):
        port_predict.check_flags(_serving_args("--dataset_type", "native"))


def test_predict_refuses_before_it_reads_anything(served):
    root, paths, videos, checkpoints = served
    argv = _argv(root, paths, videos, "cacnf", checkpoints["cacnf"], "--platform", "cpu",
                 "--model_parallel", "3")  # the model axis runs; 3 does not divide the heads
    with pytest.raises(ValueError, match="--model_parallel 3 does not divide --num_attention_heads"):
        port_predict.main(argv + ["--output", os.path.join(root, "never.jsonl")])
    assert not os.path.exists(os.path.join(root, "never.jsonl"))
