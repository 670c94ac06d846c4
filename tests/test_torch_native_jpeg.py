"""The port's C++ JPEG stage (``stlt_tpu_torch/data/native_jpeg.py``) and
``--native_decode`` against PIL and JAX's native stage
(``stlt_tpu/data/native_jpeg.py``).

The resize and the colour jitter reimplement Pillow's fixed-point
arithmetic and are held bit for bit; the decode equals PIL's where PIL's
libjpeg is the system's, which JAX's ``tests/test_native_jpeg.py`` holds on
this machine, so it is held bit for bit here too. The appearance dataset's
native route draws the generator as its PIL route does: the same clip from
the same seed, bit for bit, and ``predict``, ``inference`` and ``train``
give the same rows, metrics and losses either way.
"""

import io

import numpy as np
import pytest
from PIL import Image

from stlt_tpu.configs import DataConfig as JaxDataConfig
from stlt_tpu.data import datasets_factory as jax_datasets
from stlt_tpu.data import native_jpeg as jax_native_jpeg
from stlt_tpu.data.transforms import VideoColorJitter as JaxVideoColorJitter
from stlt_tpu_torch import inference as port_inference
from stlt_tpu_torch import predict as port_predict
from stlt_tpu_torch import train as port_train
from stlt_tpu_torch.configs import DataConfig
from stlt_tpu_torch.data import datasets_factory
from stlt_tpu_torch.data import native_jpeg
from stlt_tpu_torch.data.transforms import VideoColorJitter, resize_shorter_side
from tests.fixtures import make_something_fixture, make_video_hdf5
from tests.test_torch_multimodal import _argv as multimodal_argv
from tests.test_torch_multimodal import _random_checkpoint


def _random_image(rng, w, h):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _encode(arr, quality=87):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("in_wh,out_wh", [
    ((320, 240), (171, 128)),  # down
    ((100, 80), (160, 128)),  # up
    ((317, 211), (192, 128)),  # odd sizes
    ((64, 480), (128, 960)),  # tall
    ((128, 100), (128, 77)),  # one axis unchanged
])
def test_resize_equals_pil_and_jax(in_wh, out_wh):
    (iw, ih), (ow, oh) = in_wh, out_wh
    img = _random_image(np.random.default_rng(0), iw, ih)
    got = native_jpeg.resize_rgb(img, ow, oh)
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize((ow, oh),
                                                                              Image.BILINEAR)))
    np.testing.assert_array_equal(got, jax_native_jpeg.resize_rgb(img, ow, oh))


@pytest.mark.parametrize("draft", [False, True], ids=["full", "draft"])
@pytest.mark.parametrize("wh,quality", [((320, 240), 85), ((640, 360), 75), ((170, 128), 95)])
def test_decode_resize_equals_pil_and_jax(wh, quality, draft):
    data = _encode(_random_image(np.random.default_rng(1), *wh), quality)
    img = Image.open(io.BytesIO(data))
    if draft:
        img.draft("RGB", (128, 128))
    want = np.asarray(resize_shorter_side(img.convert("RGB"), 128))
    got = native_jpeg.decode_resize(data, 128, draft=draft)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native_jpeg.decode_resize(data, 128, draft=draft))


def test_decode_returns_none_for_what_is_no_jpeg():
    assert native_jpeg.decode_resize(b"not a jpeg", 128) is None
    assert native_jpeg.decode_resize(_encode(np.zeros((40, 40, 3), np.uint8))[:60], 128) is None


def test_jitter_equals_the_pil_chain_and_jax():
    rng = np.random.default_rng(3)
    for n in range(20):
        arr = _random_image(rng, 53, 40)
        jitter = VideoColorJitter(np.random.default_rng(n))
        want = np.asarray(jitter(Image.fromarray(arr)))
        got = arr.copy()
        native_jpeg.jitter_rgb(got, jitter)
        np.testing.assert_array_equal(got, want)
        theirs = arr.copy()
        assert jax_native_jpeg.jitter_rgb(theirs, JaxVideoColorJitter(np.random.default_rng(n)))
        np.testing.assert_array_equal(got, theirs)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native_jpeg.jitter_rgb(arr[:, ::2], jitter)


def test_hue_round_trip_equals_pil():
    """A dense colour sweep through the HSV round trip at a fixed shift, the
    op where float promotion flips pixels by one."""
    arr = np.random.default_rng(4).integers(0, 256, (256, 400, 3), dtype=np.uint8)
    shift = -21
    hsv = np.asarray(Image.fromarray(arr).convert("HSV"))
    shifted = (hsv[..., 0].astype(np.int16) + shift).astype(np.uint8)
    want = np.asarray(Image.merge("HSV", [Image.fromarray(shifted, "L"),
                                          Image.fromarray(hsv[..., 1], "L"),
                                          Image.fromarray(hsv[..., 2], "L")]).convert("RGB"))

    class HueOnly:
        order = [3, 0, 1, 2]
        brightness = contrast = saturation = 1.0
        hue = shift / 255.0

    got = arr.copy()
    native_jpeg.jitter_rgb(got, HueOnly())
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_jpeg"))
    paths, _, _, sizes = make_something_fixture(root, num_videos=4)
    return root, paths, make_video_hdf5(root, sizes, num_frames=9)


@pytest.mark.parametrize("train,device_normalize,fast_decode", [
    (False, False, False), (True, False, False), (False, True, True), (True, True, True),
])
def test_native_route_equals_the_pil_route_and_jax(archive, train, device_normalize, fast_decode):
    """The appearance dataset's clips under ``native_decode`` equal its PIL
    route's and JAX's native route's, bit for bit, from the same seeds
    (eval's centre crop; train's jitter and shared crop)."""
    _, paths, videos = archive
    kw = dict(dataset_name="something", train=train, videos_path=videos, appearance_num_frames=4,
              spatial_size=64, device_normalize=device_normalize, fast_decode=fast_decode, **paths)
    native = datasets_factory["appearance"](DataConfig(native_decode=True, **kw))
    pil = datasets_factory["appearance"](DataConfig(**kw))
    theirs = jax_datasets["appearance"](JaxDataConfig(native_decode=True, **kw))
    for i in range(len(native)):
        got = native.__getitem__(i, rng=np.random.default_rng(42 + i))
        for other in (pil, theirs):
            want = other.__getitem__(i, rng=np.random.default_rng(42 + i))
            assert got["video_frames"].dtype == want["video_frames"].dtype
            np.testing.assert_array_equal(got["video_frames"], want["video_frames"])
            assert got["labels"] == want["labels"]


def test_a_stage_that_does_not_build_raises_with_the_compilers_words(archive, monkeypatch):
    """No libjpeg to link: loading the stage raises with the linker's words,
    and the dataset reads no frame through PIL."""
    _, paths, videos = archive
    monkeypatch.setattr(native_jpeg, "LINK", ("-lno_such_jpeg_library",))
    monkeypatch.setattr(native_jpeg, "_lib", None)
    dataset = datasets_factory["appearance"](DataConfig(
        dataset_name="something", native_decode=True, videos_path=videos, **paths))
    with pytest.raises(RuntimeError, match="cannot find -lno_such_jpeg_library"):
        dataset[0]


@pytest.mark.parametrize("module", [port_predict, port_inference, port_train])
def test_native_decode_passes_the_clis_checks(module):
    args = module.build_parser("test").parse_args([
        "--dataset_name", "something", "--dataset_type", "multimodal", "--model_name", "cacnf",
        "--native_decode", "--save_model_path", "best.pt"])
    module.check_flags(args)


def test_predict_with_native_decode_writes_the_pil_routes_rows(archive, tmp_path):
    """``predict --native_decode --platform cpu`` of a CACNF writes the
    rows the PIL route writes, exactly."""
    import json

    root, paths, videos = archive
    checkpoint = _random_checkpoint(str(tmp_path), "cacnf", 4)
    rows = []
    for extra in ([], ["--native_decode"]):
        out = str(tmp_path / f"rows{len(extra)}.jsonl")
        port_predict.main(multimodal_argv(root, paths, videos, "cacnf", checkpoint, "--platform",
                                          "cpu", "--output", out, "--top_k", "3", *extra))
        with open(out) as f:
            rows.append([json.loads(line) for line in f])
    assert len(rows[0]) == 4 and rows[0] == rows[1]


def test_train_and_inference_with_native_decode_equal_the_pil_route(archive, tmp_path):
    """``train --native_decode`` (the jitter and crop drawn as the PIL route
    draws them) takes the PIL route's steps, losses and metrics exactly, and
    ``inference --native_decode`` of the trained model its metrics."""
    root, paths, videos = archive
    common = multimodal_argv(root, paths, videos, "cacnf", "unused.pt", "--platform", "cpu")
    common = common[:common.index("--checkpoint_path")] + common[common.index("--checkpoint_path") + 2:]
    common.remove("--test_dataset_path")
    common.remove(paths["dataset_path"])
    results = []
    for extra in ([], ["--native_decode"]):
        best = str(tmp_path / f"best{len(extra)}.pt")
        trained = port_train.main(common + [
            "--train_dataset_path", paths["dataset_path"], "--val_dataset_path",
            paths["dataset_path"], "--epochs", "1", "--warmup_epochs", "1",
            "--save_model_path", best, *extra])
        metrics = port_inference.main(common + ["--test_dataset_path", paths["dataset_path"],
                                                "--checkpoint_path", best, *extra])
        results.append(([r["train_loss"] for r in trained.epochs],
                        [r["metrics"] for r in trained.epochs], metrics))
    assert results[0][0] and np.isfinite(results[0][0]).all()
    assert results[1] == results[0]
