"""The appearance branch through the port (plain versions on the CPU)
against the JAX package: the ``resnet3d`` and ``resnet3d-transformer``
models, the converter on their trees (R3D depth 10 and 50), and the
appearance data pipeline (HDF5 JPEG frames, samplers, transforms, the
multimodal dataset and collater; and ``chip_smoke.py``'s frames-directory
stand-in for the archive).

Same numpy-seeded inputs and the same weights through both (a seeded port
model's state_dict into JAX's tree by the JAX package's
``torch_to_flax_params``, back by the port's ``jax_params_to_state_dict``);
JAX runs ``use_pallas=True`` with its Pallas kernels in interpret mode.
Tolerances: logits f32 atol 2e-5, rtol 1e-5 (``tests/test_torch_long_context.py``);
the data pipeline is the same numpy and PIL arithmetic, so its arrays are
equal exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from stlt_tpu.configs import DataConfig as JaxDataConfig
from stlt_tpu.data import collaters_factory as jax_collaters
from stlt_tpu.data import datasets_factory as jax_datasets
from stlt_tpu.data.samplers import sample_appearance_indices as jax_sample_appearance_indices
from stlt_tpu.utils.convert import flax_to_torch_state_dict
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data import collaters_factory, datasets_factory
from stlt_tpu_torch.data.samplers import sample_appearance_indices
from stlt_tpu_torch.models import models_factory
from stlt_tpu_torch.ops import fused_encoder as fe
from stlt_tpu_torch.utils.convert import jax_params_to_state_dict
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.test_torch_fusion import LOGITS_TOL, carried_params, jax_model, port_config, port_logits


def _frames(clips=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"video_frames": rng.standard_normal((clips, 8, 32, 32, 3)).astype(np.float32)}


@pytest.mark.parametrize("name", ["resnet3d", "resnet3d-transformer"])
def test_appearance_logits_match_jax(name, monkeypatch):
    """The logits, and the transformer's encoder on the fused ops with the
    ReLU tail (activation code 0, eps 1e-5)."""
    tails = []
    real = fe.fused_layer_tail

    def spy(*args, **kw):
        tails.append((kw["activation"], kw["eps"]))
        return real(*args, **kw)

    monkeypatch.setattr(fe, "fused_layer_tail", spy)
    cfg, model = jax_model(name, 7)
    inputs = _frames()
    params = carried_params(name, cfg, model, inputs, seed=2)
    want = model.apply({"params": params}, inputs)
    got = port_logits(name, cfg, params, inputs)
    assert tuple(got) == ("resnet3d",)
    np.testing.assert_allclose(got["resnet3d"].numpy(), np.asarray(want["resnet3d"]), **LOGITS_TOL)
    assert tails == ([("relu", 1e-5)] if name == "resnet3d-transformer" else [])
    exported = {k: torch.from_numpy(np.array(v)) for k, v in flax_to_torch_state_dict(params).items()}
    models_factory[name](port_config(name, cfg)).load_state_dict(exported, strict=True)


@pytest.mark.parametrize("name", ["resnet3d", "resnet3d-transformer", "cacnf"])
def test_r3d50_trees_carry_across_strictly(name):
    """At R3D depth 50 (Bottleneck blocks, the reference's
    ``nn.Sequential`` numbering) the JAX tree's shapes (no compute) carry to
    the port's state_dict and back with strict=True."""
    cfg, model = jax_model(name, 7)
    cfg = dataclasses.replace(cfg, resnet_depth=50)
    model = type(model)(cfg)
    inputs = {**_frames(clips=1), **{k: v[:1] for k, v in _layout(7).items()}}
    params = carried_params(name, cfg, model, inputs, seed=0)
    port = models_factory[name](port_config(name, cfg))
    carried = jax_params_to_state_dict(params)
    port.load_state_dict(carried, strict=True)
    assert any(k.endswith("resnet.7.2.conv3.weight") for k in carried)  # layer4's last Bottleneck
    exported = flax_to_torch_state_dict(params)
    assert set(exported) == set(port.state_dict())


def _layout(frames):
    from tests.test_torch_fusion import model_inputs

    return {k: v for k, v in model_inputs(frames, (3, frames), seed=0).items() if k != "video_frames"}


def test_device_normalize_equals_the_host_normalisation():
    """uint8 frames normalised on the device equal the host pipeline's f32
    frames (same constants, same op order)."""
    cfg, model = jax_model("resnet3d", 7)
    port = models_factory["resnet3d"](port_config("resnet3d", cfg)).eval()
    raw = np.random.default_rng(0).integers(0, 256, (1, 8, 32, 32, 3), dtype=np.uint8)
    host = raw.astype(np.float32) / 127.5 - 1.0
    with torch.inference_mode():
        a = port({"video_frames": torch.from_numpy(raw)})["resnet3d"]
        b = port({"video_frames": torch.from_numpy(host)})["resnet3d"]
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_token_count_must_match_the_pos_embed_table():
    cfg, _ = jax_model("resnet3d-transformer", 7)
    model = models_factory["resnet3d-transformer"](
        dataclasses.replace(port_config("resnet3d-transformer", cfg), appearance_num_frames=4)).eval()
    with pytest.raises(ValueError, match="R3D emitted 1 tokens"):
        model({"video_frames": torch.from_numpy(_frames()["video_frames"])})


# --- data -------------------------------------------------------------------------


@pytest.mark.parametrize("num_video_frames", [1, 2, 5, 30, 64, 65, 200])
@pytest.mark.parametrize("train", [False, True])
def test_appearance_sampler_matches_jax(num_video_frames, train):
    got = sample_appearance_indices(32, num_video_frames, train, rng=np.random.default_rng(3))
    want = jax_sample_appearance_indices(32, num_video_frames, train, rng=np.random.default_rng(3))
    assert got == want


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("appearance"))
    paths, _, _, sizes = make_something_fixture(root, num_videos=3)
    return dict(paths, videos_path=make_video_hdf5(root, sizes, num_frames=9))


@pytest.mark.parametrize("dataset_type", ["appearance", "multimodal"])
@pytest.mark.parametrize("train,device_normalize,fast_decode", [
    (False, False, False), (True, False, False), (False, True, True), (True, True, False),
])
def test_appearance_data_matches_jax(archive, dataset_type, train, device_normalize, fast_decode):
    """Eval (centre crop) and train (the per-clip colour jitter and shared
    random crop drawn from the same generator) frames, raw uint8 or
    normalised, collated, equal JAX's exactly."""
    kw = dict(dataset_name="something", train=train, layout_num_frames=4, appearance_num_frames=4,
              spatial_size=64, device_normalize=device_normalize, fast_decode=fast_decode,
              **archive)
    port_cfg, jax_cfg = DataConfig(**kw), JaxDataConfig(**kw)
    port_ds = datasets_factory[dataset_type](port_cfg)
    jax_ds = jax_datasets[dataset_type](jax_cfg)
    port_samples = [port_ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(len(port_ds))]
    jax_samples = [jax_ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(len(jax_ds))]
    got = collaters_factory[dataset_type](port_cfg)(port_samples)
    want = jax_collaters[dataset_type](jax_cfg)(jax_samples)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    frames = got["video_frames"]
    assert frames.shape == (3, 4, 64, 64, 3)
    assert frames.dtype == (np.uint8 if device_normalize else np.float32)


def test_frames_directory_reads_the_frames_the_archive_holds(archive, tmp_path):
    """``chip_smoke.frames_directory_videos`` (the card's machine has no
    h5py) hands the dataset a directory of ``<video_id>/<index>.jpg`` (what
    ``tools/frames2hdf5.py`` packs) in the HDF5 archive's place: the same
    frames as the archive, and the archive's reader back after the block."""
    import h5py

    import chip_smoke

    with h5py.File(archive["videos_path"], "r") as f:
        for vid in f:
            os.makedirs(tmp_path / vid)
            for key in f[vid]:
                (tmp_path / vid / f"{key}.jpg").write_bytes(np.asarray(f[vid][key]).tobytes())
    kw = dict(dataset_name="something", layout_num_frames=4, appearance_num_frames=4,
              spatial_size=64, **archive)
    from_archive = datasets_factory["multimodal"](DataConfig(**kw))
    want = [from_archive[i]["appearance"]["video_frames"] for i in range(len(from_archive))]
    with chip_smoke.frames_directory_videos():
        from_dir = datasets_factory["multimodal"](DataConfig(**dict(kw, videos_path=str(tmp_path))))
        got = [from_dir[i]["appearance"]["video_frames"] for i in range(len(from_dir))]
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)
    again = datasets_factory["multimodal"](DataConfig(**kw))
    np.testing.assert_array_equal(again[0]["appearance"]["video_frames"], want[0])


def test_native_decode_raises_and_does_not_fall_back(archive):
    cfg = DataConfig(dataset_name="something", native_decode=True, **archive)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A10"):
        datasets_factory["appearance"](cfg)
