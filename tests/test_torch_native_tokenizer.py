"""The port's C++ layout tokenizer (``stlt_tpu_torch/data/native.py``, the
``"layout"`` factory) against its plain version, the port's Python
``LayoutDataset``, and against JAX's native and Python datasets; and the
port's build helper (``stlt_tpu_torch/data/_native_build.py``).

Every array is compared bit for bit (the same integer box repairs, one f32
division each, the same samplers drawn from generators seeded alike).
"""

import concurrent.futures
import ctypes
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from stlt_tpu.configs import DataConfig as JaxDataConfig
from stlt_tpu.data.layout import LayoutDataset as JaxLayoutDataset
from stlt_tpu.data.native import NativeLayoutDataset as JaxNativeLayoutDataset
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data import _native_build as nb
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.layout import LayoutDataset
from stlt_tpu_torch.data.loader import Loader
from stlt_tpu_torch.data.multimodal import MultimodalDataset
from stlt_tpu_torch.data.native import NativeLayoutDataset
from tests.fixtures import make_action_genome_fixture, make_something_fixture, make_video_hdf5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("categories", "boxes", "scores", "frame_types", "lengths", "labels")


def _fixture(root, dataset_name):
    if dataset_name == "something":
        return make_something_fixture(root, num_videos=12, num_frames_range=(2, 40))[0]
    return make_action_genome_fixture(root, num_videos=6)[0]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dataset_name", ["something", "action_genome"])
def test_native_clips_equal_the_python_and_jax_datasets(tmp_path, dataset_name, train):
    """Every clip of the port's native dataset equals, bit for bit, the
    port's Python dataset's and JAX's native and Python datasets' (train
    sampling from the same seeded generator), with the same scanned
    ``max_num_objects`` and ``max_video_frames``."""
    paths = _fixture(str(tmp_path), dataset_name)
    kw = dict(dataset_name=dataset_name, train=train, layout_num_frames=8, **paths)
    port_cfgs = [DataConfig(**kw, max_num_objects=99) for _ in range(2)]
    jax_cfgs = [JaxDataConfig(**kw) for _ in range(2)]
    datasets = [NativeLayoutDataset(port_cfgs[0]), LayoutDataset(port_cfgs[1]),
                JaxNativeLayoutDataset(jax_cfgs[0]), JaxLayoutDataset(jax_cfgs[1])]
    assert len({len(d) for d in datasets}) == 1
    assert {c.max_num_objects for c in port_cfgs + jax_cfgs} == {jax_cfgs[1].max_num_objects}
    assert datasets[0].max_video_frames() == datasets[1].max_video_frames() == max(
        len(v["frames"]) for v in datasets[1].json_file)
    assert datasets[0].video_ids == [v["id"] for v in datasets[1].json_file]
    for i in range(len(datasets[0])):
        clips = [d.__getitem__(i, rng=np.random.default_rng(100 + i)) for d in datasets]
        for clip in clips[1:]:
            assert clip["video_id"] == clips[0]["video_id"]
            for key in KEYS:
                np.testing.assert_array_equal(clips[0][key], clip[key], err_msg=key)
                assert clips[0][key].dtype == clip[key].dtype, key


def test_unknown_category_raises_key_error(tmp_path):
    paths, videos, *_ = make_something_fixture(str(tmp_path), num_videos=2)
    videos[0]["frames"][0]["frame_objects"].append(
        {"category": "spaceship", "x1": 1, "y1": 1, "x2": 5, "y2": 5, "score": 0.9})
    with open(paths["dataset_path"], "w") as f:
        json.dump(videos, f)
    dataset = NativeLayoutDataset(DataConfig(dataset_name="something", **paths))
    with pytest.raises(KeyError, match="unknown category in clip 10000"):
        dataset[0]
    dataset[1]


def test_a_dataset_without_frames_raises(tmp_path):
    paths, videos, *_ = make_something_fixture(str(tmp_path), num_videos=2)
    with open(paths["dataset_path"], "w") as f:
        json.dump([dict(v, frames=[]) for v in videos], f)
    with pytest.raises(ValueError, match="no frames at all"):
        NativeLayoutDataset(DataConfig(dataset_name="something", **paths))


def test_the_layout_factory_is_the_native_tokenizer(tmp_path):
    """``datasets_factory["layout"]`` is the native dataset, with no switch
    or fallback; the multimodal dataset keeps the Python one, as JAX's."""
    paths, _, _, sizes = make_something_fixture(str(tmp_path), num_videos=3)
    assert datasets_factory["layout"] is NativeLayoutDataset
    cfg = DataConfig(dataset_name="something", **paths)
    assert isinstance(datasets_factory["layout"](cfg), NativeLayoutDataset)
    videos = make_video_hdf5(str(tmp_path), sizes, num_frames=4)
    multimodal = MultimodalDataset(DataConfig(dataset_name="something", videos_path=videos, **paths))
    assert type(multimodal.layout_dataset) is LayoutDataset


def test_the_arena_is_freed_once_after_the_loader_threads(tmp_path):
    """A loader's threads hold the dataset while they run; the arena is
    freed when the last reference goes, and once. Two datasets of one file
    hold arenas of their own."""
    paths, *_ = make_something_fixture(str(tmp_path), num_videos=10)
    cfg = DataConfig(dataset_name="something", layout_num_frames=8, **paths)
    dataset, other = NativeLayoutDataset(cfg), NativeLayoutDataset(cfg)
    assert other._handle != dataset._handle
    loader = Loader(dataset, 4, collaters_factory["layout"](cfg), prefetch=2, workers=2)
    batches = list(loader)
    free = dataset._free
    assert free.alive and len(batches) == 3
    del dataset, loader, batches
    gc.collect()
    assert not free.alive and free() is None  # called once; a second call does nothing
    np.testing.assert_array_equal(other[9]["boxes"], LayoutDataset(cfg)[9]["boxes"])


def test_predict_over_the_native_dataset_writes_the_python_datasets_rows(tmp_path, monkeypatch):
    """``predict --platform cpu`` over the native tokenizer writes the rows
    it wrote over the Python dataset, exactly."""
    import torch

    from stlt_tpu_torch.configs import make_model_config, position_table_rows
    from stlt_tpu_torch.models import models_factory

    root = str(tmp_path)
    paths, *_ = make_something_fixture(root, num_videos=7)
    model = models_factory["stlt"](
        make_model_config("stlt", num_classes=4, unique_categories=4, hidden_size=32,
                          num_attention_heads=4, num_spatial_layers=1, num_temporal_layers=1,
                          layout_num_frames=position_table_rows(
                              DataConfig(dataset_name="something", layout_num_frames=8))),
        torch.Generator().manual_seed(5))
    checkpoint = os.path.join(root, "random.pt")
    torch.save(model.state_dict(), checkpoint)

    def run(name):
        out = os.path.join(root, f"{name}.jsonl")
        port_predict.main([
            "--dataset_name", "something", "--dataset_type", "layout", "--model_name", "stlt",
            "--test_dataset_path", paths["dataset_path"], "--labels_path", paths["labels_path"],
            "--videoid2size_path", paths["videoid2size_path"], "--checkpoint_path", checkpoint,
            "--layout_num_frames", "8", "--batch_size", "4", "--hidden_size", "32",
            "--num_attention_heads", "4", "--num_spatial_layers", "1",
            "--num_temporal_layers", "1", "--output", out, "--top_k", "3", "--platform", "cpu"])
        with open(out) as f:
            return [json.loads(line) for line in f]

    native = run("native")
    monkeypatch.setitem(datasets_factory, "layout", LayoutDataset)
    python = run("python")
    assert len(native) == 7 and native == python


# --- the build helper ------------------------------------------------------------


@pytest.fixture()
def tiny_src(tmp_path):
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    return src


def test_a_failed_build_raises_with_the_compilers_stderr(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int answer() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="(?s)failed to build .*undeclared_name"):
        nb.load_shared_library(src, "broken", build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())  # no half-written library left
    src.write_text('extern "C" int answer() { return 42; }\n')
    with pytest.raises(RuntimeError, match="cannot find -lno_such_library_anywhere"):
        nb.build_shared_library(src, "unlinked", ["-lno_such_library_anywhere"],
                                build_dir=tmp_path / "build")


def test_concurrent_forced_builds_publish_a_loadable_library(tiny_src, tmp_path):
    """Threads and processes forcing the same build at once each load a
    whole library, and leave no temporary file."""
    build = tmp_path / "build"
    code = ("import sys; from stlt_tpu_torch.data import _native_build as nb; "
            f"print(nb.load_shared_library({str(tiny_src)!r}, 'tiny', build_dir={str(build)!r})"
            ".answer())")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]

    def build_and_load(_):
        path = nb.build_shared_library(tiny_src, "tiny", build_dir=build, force=True)
        return ctypes.CDLL(str(path)).answer()

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        assert list(ex.map(build_and_load, range(8))) == [42] * 8
    assert [p.communicate(timeout=120)[0].strip() for p in procs] == ["42", "42"]
    assert [f.name for f in build.iterdir()] == [nb.library_path(tiny_src, "tiny").name]


def test_a_changed_source_or_another_host_rebuilds(tiny_src, tmp_path, monkeypatch):
    """The library's name carries the source's hash and the host's
    ``-march=native`` target: an edited source builds anew, the built one is
    reused, and a library built for another host is not loaded here."""
    build = tmp_path / "build"
    first = nb.build_shared_library(tiny_src, "tiny", build_dir=build)
    assert nb.build_shared_library(tiny_src, "tiny", build_dir=build) == first
    tiny_src.write_text('extern "C" int answer() { return 7; }\n')
    second = nb.build_shared_library(tiny_src, "tiny", build_dir=build)
    assert second != first and ctypes.CDLL(str(second)).answer() == 7
    monkeypatch.setattr(nb, "_host_target", lambda: b"another host's target")
    assert nb.library_path(tiny_src, "tiny", build_dir=build) not in (first, second)
