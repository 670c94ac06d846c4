"""The port's tools (``stlt_tpu_torch/tools``) against the JAX package's
(``tools/``), on the CPU.

- ``dump_features`` and ``dump_perbox_features`` on a tiny HDF5 archive
  (``tests/fixtures.make_video_hdf5``), R3D depth 10 at 32 px, with one
  fabricated Kinetics-format checkpoint given to both tools, so the trunks'
  weights agree. Both tools compute in bf16 by their code; here JAX's
  ``AppearanceModelConfig`` and the port's ``dump_features.COMPUTE_DTYPE``
  are patched to f32 for the test's duration, in this process only.
  Keys and shapes equal; features within FEATURE_TOL (the same f32
  function, the convolutions' sums in another order; sound runs read at
  most 1.1e-6 on features up to 2.0). The resumed run skips what is written and rewrites what a
  cut run left half written.
- ``verify_checkpoints`` on a fabricated manifest (a seeded port STLT saved
  as a reference-format ``.pt``): the same records as JAX's tool.
"""

import importlib.util
import json
import os

import h5py
import numpy as np
import pytest
import torch

import stlt_tpu.configs as jax_configs
from stlt_tpu_torch.configs import DataConfig, make_model_config, position_table_rows
from stlt_tpu_torch.models import models_factory, resnet3d
from stlt_tpu_torch.tools import STAGING, dump_features, dump_perbox_features, verify_checkpoints
from tests.fixtures import make_something_fixture, make_video_hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)
KINETICS_NAMES = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
                  "7": "layer4"}


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_kinetics_checkpoint(path, depth=10, seed=3):
    """A Kinetics-format R3D state_dict (``conv1``, ``bn1``, ``layer1.0...``,
    an ``fc`` both loaders drop): seeded He-scaled convolutions and batch
    norms near the identity, so the features stay of order one."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in resnet3d.r3d_trunk(depth, torch.Generator().manual_seed(0)).state_dict().items():
        head, _, rest = key.partition(".")
        noise = torch.randn(value.shape, generator=gen) if value.is_floating_point() else None
        if noise is None:
            pass
        elif value.dim() == 5:  # a convolution
            value = noise * (2.0 / value[0].numel()) ** 0.5
        elif key.endswith("running_var"):
            value = 1.0 + 0.2 * noise.abs()
        elif key.endswith("weight"):
            value = 1.0 + 0.1 * noise
        else:  # bias, running_mean
            value = 0.1 * noise
        state[f"{KINETICS_NAMES[head]}.{rest}"] = value
    state["fc.weight"] = torch.randn(400, 512, generator=gen)
    state["fc.bias"] = torch.randn(400, generator=gen)
    torch.save({"state_dict": state}, path)
    return path


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    paths, videos, _, sizes = make_something_fixture(str(root), num_videos=3, seed=4)
    return dict(root=root, paths=paths, videos=videos,
                videos_path=make_video_hdf5(str(root), sizes, num_frames=6),
                kinetics=write_kinetics_checkpoint(str(root / "r3d10_kinetics.pth")))


@pytest.fixture()
def f32(monkeypatch):
    """Both packages' dump tools build their R3D trunk in f32."""
    cls = jax_configs.AppearanceModelConfig
    monkeypatch.setattr(jax_configs, "AppearanceModelConfig",
                        lambda **kw: cls(**dict(kw, compute_dtype="float32")))
    monkeypatch.setattr(dump_features, "COMPUTE_DTYPE", "float32")


def run_jax_tool(name, monkeypatch, argv):
    monkeypatch.setattr("sys.argv", [name, *argv])
    jax_tool(name).main()


def read_groups(path):
    with h5py.File(path, "r") as f:
        return {vid: {key: np.asarray(f[vid][key]) for key in f[vid]} for vid in f}


def check_same_features(got, want):
    assert set(got) == set(want) and want
    for vid in want:
        assert set(got[vid]) == set(want[vid]), vid
        for key in want[vid]:
            assert got[vid][key].dtype == np.float32 and got[vid][key].shape == want[vid][key].shape
            np.testing.assert_allclose(got[vid][key], want[vid][key], err_msg=f"{vid}/{key}",
                                       **FEATURE_TOL)


def check_resumes(tool, argv, out_path, first):
    """A second run writes nothing; with one group removed and another left
    half written under the staging group, it writes those two again, equal
    to the first run's, and leaves no staging group."""
    assert tool.main(argv) == 0
    ids = sorted(first)
    with h5py.File(out_path, "a") as f:
        del f[ids[0]]
        f.require_group(STAGING).create_group(ids[1])
        del f[ids[1]]
    assert tool.main(argv) == 2
    with h5py.File(out_path, "r") as f:
        assert STAGING not in f
    again = read_groups(out_path)
    assert set(again) == set(first)
    for vid in first:
        for key in first[vid]:
            np.testing.assert_array_equal(again[vid][key], first[vid][key])


def test_dump_features_matches_jax_and_resumes(archive, f32, monkeypatch):
    paths, root = archive["paths"], archive["root"]
    common = ["--dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
              "--videoid2size_path", paths["videoid2size_path"],
              "--videos_path", archive["videos_path"], "--resnet_model_path", archive["kinetics"],
              "--appearance_num_frames", "4", "--spatial_size", "32", "--resnet_depth", "10",
              "--batch_size", "2"]
    run_jax_tool("dump_features", monkeypatch, [*common, "--save_features_path",
                                                str(root / "jax_features.h5")])
    port_path = str(root / "port_features.h5")
    argv = [*common, "--save_features_path", port_path, "--platform", "cpu"]
    assert dump_features.main(argv) == 3
    got = read_groups(port_path)
    check_same_features(got, read_groups(str(root / "jax_features.h5")))
    for groups in got.values():
        assert groups["features"].shape == (1, 512)  # 4 frames: one temporal unit of depth 10
        np.testing.assert_allclose(groups["pooled"], groups["features"].mean(axis=0), atol=1e-6)
    check_resumes(dump_features, argv, port_path, got)


def test_dump_perbox_features_matches_jax_and_resumes(archive, f32, monkeypatch):
    paths, root = archive["paths"], archive["root"]
    common = ["--dataset_path", paths["dataset_path"], "--videos_path", archive["videos_path"],
              "--resnet_model_path", archive["kinetics"], "--spatial_size", "32",
              "--resnet_depth", "10", "--window", "4"]
    run_jax_tool("dump_perbox_features", monkeypatch, [*common, "--save_features_path",
                                                       str(root / "jax_perbox.h5")])
    port_path = str(root / "port_perbox.h5")
    argv = [*common, "--save_features_path", port_path, "--platform", "cpu"]
    assert dump_perbox_features.main(argv) == 3
    got = read_groups(port_path)
    check_same_features(got, read_groups(str(root / "jax_perbox.h5")))
    for video in archive["videos"]:
        frames = min(6, len(video["frames"]))
        want = {f"{i}-frame" for i in range(frames)} | {
            f"{i}-frame-{k}-box" for i in range(frames)
            for k in range(len(video["frames"][i]["frame_objects"]))}
        assert set(got[video["id"]]) == want
        assert got[video["id"]]["0-frame"].shape == (9 * 512,)
    check_resumes(dump_perbox_features, argv, port_path, got)


def test_perbox_helpers_match_jax():
    jax_perbox = jax_tool("dump_perbox_features")
    keys = ["10", "2", "1", "frame_10", "frame_2", "00003"]
    assert dump_perbox_features.natural_sorted(keys) == jax_perbox.natural_sorted(keys) == [
        "1", "2", "00003", "10", "frame_2", "frame_10"]
    boxes = np.array([[0, 0, 320, 240], [10.5, -3, 400, 90]], np.float32)
    np.testing.assert_array_equal(
        dump_perbox_features.transform_boxes(boxes, (240, 320), (128, 170), (8, 29)),
        jax_perbox.transform_boxes(boxes, (240, 320), (128, 170), (8, 29)))


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A fabricated zoo: a seeded port STLT saved as a reference-format
    ``.pt`` beside a Something-Else fixture, and a manifest entry for it."""
    root = str(tmp_path_factory.mktemp("zoo"))
    paths, *_ = make_something_fixture(root, num_videos=8, seed=7)
    model = models_factory["stlt"](
        make_model_config("stlt", num_classes=4, unique_categories=4, hidden_size=32,
                          num_attention_heads=4, num_spatial_layers=1, num_temporal_layers=1,
                          layout_num_frames=position_table_rows(
                              DataConfig(dataset_name="something", layout_num_frames=8))),
        torch.Generator().manual_seed(9))
    torch.save(model.state_dict(), os.path.join(root, "stlt.pt"))
    entry = {
        "name": "stlt-fabricated", "model_name": "stlt", "dataset_name": "something",
        "dataset_type": "layout", "checkpoint_path": "stlt.pt",
        "test_dataset_path": os.path.basename(paths["dataset_path"]),
        "labels_path": os.path.basename(paths["labels_path"]),
        "videoid2size_path": os.path.basename(paths["videoid2size_path"]),
        "extra_args": {"layout_num_frames": 8, "batch_size": 4, "hidden_size": 32,
                       "num_attention_heads": 4, "num_spatial_layers": 1,
                       "num_temporal_layers": 1},
        "expected": {}, "tolerance": 0.2,
    }
    return root, entry


def write_manifest(root, name, entries):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump({"entries": entries}, f)
    return path


def test_verify_checkpoints_reports_what_jax_reports(zoo):
    """The port's records equal JAX's tool's on the same manifest: the
    measured entry, an entry asserted at JAX's measured metrics, one
    asserted 0.3 points off (failed), one with a missing file (skipped)."""
    root, entry = zoo
    jax_verify = jax_tool("verify_checkpoints")
    measured = jax_verify.verify_manifest(write_manifest(root, "jax0.json", [entry]))[0]["metrics"]
    entries = [entry, dict(entry, name="at", expected=measured),
               dict(entry, name="off", expected={k: v + 0.3 for k, v in measured.items()}),
               dict(entry, name="gone", checkpoint_path="nope.pt")]
    want = jax_verify.verify_manifest(write_manifest(root, "jax.json", entries))
    port_entries = [dict(e, extra_args=dict(e["extra_args"], platform="cpu")) for e in entries]
    got = verify_checkpoints.verify_manifest(write_manifest(root, "port.json", port_entries))
    assert got == want
    assert [r.get("pass") for r in got] == [None, True, False, None]
    assert "skipped_missing_files" in got[3] and set(measured) == {
        "stlt_top1_accuracy", "stlt_top5_accuracy"}


def test_verify_checkpoints_cli_exits_1_on_a_miss(zoo, capsys):
    root, entry = zoo
    entry = dict(entry, extra_args=dict(entry["extra_args"], platform="cpu"))
    manifest = write_manifest(root, "cli.json", [entry])
    assert verify_checkpoints.main(["--manifest", manifest]) == 0
    record = json.loads(capsys.readouterr().out.strip())
    assert record["pass"] is None and record["metrics"]
    missed = dict(entry, expected={k: v + 0.3 for k, v in record["metrics"].items()})
    manifest = write_manifest(root, "cli_missed.json", [missed])
    assert verify_checkpoints.main(["--manifest", manifest, "--only", "stlt"]) == 1
    assert json.loads(capsys.readouterr().out.strip())["pass"] is False
