"""The port's serving path on the CPU: data pipeline and the prediction CLI
(``python -m stlt_tpu_torch.predict``) against the JAX package's.

Both CLIs read the same reference-format ``.pt`` checkpoint. Scores are
softmax probabilities of f32 logits, so they agree to 1e-5; top-k ids agree
wherever the scores are not tied within that.
"""

import json
import os

import numpy as np
import pytest
import torch

from stlt_tpu.configs import DataConfig as JaxDataConfig
from stlt_tpu.data.layout import LayoutDataset as JaxLayoutDataset
from stlt_tpu.data.layout import collate_layout as jax_collate_layout
from stlt_tpu.parser import build_parser as jax_build_parser
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch.configs import DataConfig, StltModelConfig, make_model_config, position_table_rows
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.loader import Loader, to_device
from stlt_tpu_torch.models import models_factory
from tests.fixtures import make_action_genome_fixture, make_something_fixture

SCORE_ATOL = 1e-5


def _argv(paths, checkpoint, *extra):
    return [
        "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
        "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
        "--videoid2size_path", paths["videoid2size_path"], "--checkpoint_path", checkpoint,
        "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
        "--num_attention_heads", "4", "--num_spatial_layers", "1",
        "--num_temporal_layers", "2", *extra,
    ]


def _port_argv(paths, checkpoint, output, *extra):
    return _argv(paths, checkpoint, "--output", output, "--top_k", "3", *extra)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A something fixture of 6 clips and a randomly initialised port STLT
    saved as a reference-format .pt."""
    root = str(tmp_path_factory.mktemp("port_predict"))
    paths, *_ = make_something_fixture(root, num_videos=6)
    data_cfg = DataConfig(dataset_name="something", layout_num_frames=8, **paths)
    model = models_factory["stlt"](
        make_model_config(
            "stlt", num_classes=4, unique_categories=4, hidden_size=32, num_attention_heads=4,
            num_spatial_layers=1, num_temporal_layers=2,
            layout_num_frames=position_table_rows(data_cfg),
        ),
        torch.Generator().manual_seed(3),
    )
    checkpoint = os.path.join(root, "random.pt")
    torch.save(model.state_dict(), checkpoint)
    return root, paths, checkpoint


@pytest.mark.parametrize("fixture", ["something", "action_genome"])
def test_layout_dataset_matches_jax(tmp_path, fixture):
    make = make_something_fixture if fixture == "something" else make_action_genome_fixture
    paths, *_ = make(str(tmp_path), num_videos=5)
    jax_ds = JaxLayoutDataset(JaxDataConfig(dataset_name=fixture, layout_num_frames=8, **paths))
    port_cfg = DataConfig(dataset_name=fixture, layout_num_frames=8, **paths)
    port_ds = datasets_factory["layout"](port_cfg)
    assert len(port_ds) == len(jax_ds) and port_cfg.max_num_objects == jax_ds.config.max_num_objects
    samples = [port_ds[i] for i in range(len(port_ds))]
    want = jax_collate_layout([jax_ds[i] for i in range(len(jax_ds))], fixture)
    got = collaters_factory["layout"](port_cfg)(samples)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_loader_pads_the_last_batch_and_moves_it_to_the_device(served):
    _, paths, _ = served
    cfg = DataConfig(dataset_name="something", layout_num_frames=8, **paths)
    loader = Loader(datasets_factory["layout"](cfg), 4, collaters_factory["layout"](cfg))
    batches = list(to_device(loader, torch.device("cpu")))
    assert [int(b["valid"].sum()) for b in batches] == [4, 2]
    last = batches[-1]
    assert last["categories"].dtype == torch.int64 and last["boxes"].dtype == torch.float32
    assert tuple(last["categories"].shape) == (4, cfg.num_total_frames, cfg.num_total_boxes)
    np.testing.assert_array_equal(last["boxes"][2].numpy(), last["boxes"][0].numpy())


def test_predict_cli_matches_jax_predict(served, tmp_path):
    from stlt_tpu.predict import predict as jax_predict

    _, paths, checkpoint = served
    port_out = str(tmp_path / "port.jsonl")
    rows = port_predict.main(_port_argv(paths, checkpoint, port_out, "--platform", "cpu"))
    jax_args = jax_build_parser("test").parse_args(_argv(paths, checkpoint, "--platform", "cpu"))
    jax_args.top_k, jax_args.output = 3, str(tmp_path / "jax.jsonl")
    want = jax_predict(jax_args)

    with open(port_out) as f:
        written = [json.loads(line) for line in f]
    with open(paths["labels_path"]) as f:
        id2label = {int(v): k for k, v in json.load(f).items()}
    assert written == rows and len(rows) == len(want) == 6
    for got_row, want_row in zip(rows, want):
        assert got_row["video_id"] == want_row["video_id"]
        got_scores = np.array([t["score"] for t in got_row["top_k"]])
        want_scores = np.array([t["score"] for t in want_row["top_k"]])
        np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_ATOL)
        for j, score in enumerate(want_scores):
            if np.all(np.abs(np.delete(want_scores, j) - score) > 2 * SCORE_ATOL):
                assert got_row["top_k"][j]["label_id"] == want_row["top_k"][j]["label_id"]
        for t in got_row["top_k"]:
            assert t["label"] == id2label[t["label_id"]]


def test_predict_without_a_gpu_raises_and_does_not_fall_back(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default platform runs there")
    _, paths, checkpoint = served
    out = str(tmp_path / "never.jsonl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict.main(_port_argv(paths, checkpoint, out))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict.main(_port_argv(paths, checkpoint, out, "--platform", "cuda"))
    assert not os.path.exists(out)


def test_predict_refuses_an_unknown_platform(served, tmp_path):
    _, paths, checkpoint = served
    with pytest.raises(ValueError, match="unknown --platform 'tpu'"):
        port_predict.main(_port_argv(paths, checkpoint, str(tmp_path / "x.jsonl"), "--platform", "tpu"))


def test_config_copies_match_jax():
    from stlt_tpu import configs as jax_configs
    from stlt_tpu_torch import configs as port_configs

    for name in ("something", "action_genome"):
        assert port_configs.category2id_for(name) == jax_configs.category2id_for(name)
        assert port_configs.frame2type_for(name) == jax_configs.frame2type_for(name)
        port_data = port_configs.DataConfig(dataset_name=name, layout_num_frames=300)
        jax_data = jax_configs.DataConfig(dataset_name=name, layout_num_frames=300)
        assert port_configs.position_table_rows(port_data) == jax_configs.position_table_rows(jax_data)
    port_model = StltModelConfig(num_classes=3, unique_categories=4)
    jax_model = jax_configs.StltModelConfig(num_classes=3, unique_categories=4)
    for field in ("hidden_size", "num_attention_heads", "num_spatial_layers",
                  "num_temporal_layers", "layout_num_frames", "layer_norm_eps", "compute_dtype"):
        assert getattr(port_model, field) == getattr(jax_model, field), field
