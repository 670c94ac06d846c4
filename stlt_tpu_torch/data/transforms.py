"""Image transforms of the appearance pipeline (PIL and numpy).

Own copy of ``stlt_tpu/data/transforms.py`` (reference
``src/modelling/datasets.py:147-198`` and ``src/utils/data_utils.py:105-137``):

- resize the shorter side to ``floor(spatial_size * 1.15)`` (bilinear,
  torchvision's truncation of the long side);
- train: one ``VideoColorJitter`` draw per clip (brightness, contrast,
  saturation and hue in a random order) and one shared random crop; eval: the
  centre crop;
- normalise to mean 0.5, std 0.5.

Pillow is imported inside the functions that use it, so importing this
module (``models/appearance.py`` reads the normalisation constants from it)
loads no image library.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# mean/std 0.5 over [0, 1], i.e. uint8 x -> x / 127.5 - 1 in f32, in this
# order on the host (normalize_to_array) and on the device
# (``--device_normalize``, models/appearance.py).
NORM_DIVISOR = 127.5
NORM_OFFSET = -1.0


def resize_target(spatial_size: int) -> int:
    return math.floor(spatial_size * 1.15)


def resize_shorter_side(img, target: int):
    """The shorter side to ``target``, the longer one truncated to
    ``int(target * long / short)`` as torchvision's ``Resize(int)`` does."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = target, max(1, int(target * h / w))
    else:
        new_w, new_h = max(1, int(target * w / h)), target
    if (new_w, new_h) == (w, h):
        return img
    return img.resize((new_w, new_h), Image.BILINEAR)


def random_crop_params(img, size: int, rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """(top, left, height, width) of one random crop shared by a clip, of a
    PIL image or a uint8 ``[H, W, 3]`` array (``--native_decode``)."""
    h, w = img.shape[:2] if isinstance(img, np.ndarray) else img.size[::-1]
    if w == size and h == size:
        return 0, 0, size, size
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return top, left, size, size


def crop(img, top: int, left: int, height: int, width: int):
    return img.crop((left, top, left + width, top + height))


def center_crop_offsets(height: int, width: int, size: int) -> Tuple[int, int]:
    """(top, left) of the centred crop."""
    return int(round((height - size) / 2.0)), int(round((width - size) / 2.0))


def center_crop(img, size: int):
    w, h = img.size
    top, left = center_crop_offsets(h, w, size)
    return img.crop((left, top, left + size, top + size))


def adjust_hue(img, hue_factor: float):
    from PIL import Image

    if abs(hue_factor) < 1e-9:
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    np_h = (np_h.astype(np.int16) + int(round(hue_factor * 255))).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(np_h, "L"), s, v)).convert("RGB")


class VideoColorJitter:
    """Colour jitter drawn once per clip and applied to every frame."""

    BRIGHTNESS = (0.75, 1.25)
    CONTRAST = (0.75, 1.25)
    SATURATION = (0.75, 1.25)
    HUE = (-0.1, 0.1)

    def __init__(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        self.order = rng.permutation(4)
        self.brightness = float(rng.uniform(*self.BRIGHTNESS))
        self.contrast = float(rng.uniform(*self.CONTRAST))
        self.saturation = float(rng.uniform(*self.SATURATION))
        self.hue = float(rng.uniform(*self.HUE))

    def __call__(self, img):
        from PIL import ImageEnhance

        for op in self.order:
            if op == 0:
                img = ImageEnhance.Brightness(img).enhance(self.brightness)
            elif op == 1:
                img = ImageEnhance.Contrast(img).enhance(self.contrast)
            elif op == 2:
                img = ImageEnhance.Color(img).enhance(self.saturation)
            else:
                img = adjust_hue(img, self.hue)
        return img


def normalize_to_array(img) -> np.ndarray:
    """A uint8 image or array as f32 with mean 0.5 and std 0.5 (range
    [-1, 1])."""
    arr = np.asarray(img, dtype=np.float32)
    return arr / NORM_DIVISOR + NORM_OFFSET
