"""Dataset/collate factories of the port (``stlt_tpu/data/__init__.py``):
``"layout"``, ``"appearance"`` and ``"multimodal"``. ``"layout"`` is the C++
tokenizer (``data/native.py``), as JAX's factory prefers it; there is no
switch and no fallback to the Python ``LayoutDataset``, its plain version,
which ``MultimodalDataset`` uses. The appearance modules (and with them h5py
and Pillow) are imported when a factory entry is called."""

from __future__ import annotations

import functools

from stlt_tpu_torch.data.layout import collate_layout
from stlt_tpu_torch.data.native import NativeLayoutDataset


def _appearance_dataset(config):
    from stlt_tpu_torch.data.appearance import AppearanceDataset

    return AppearanceDataset(config)


def _appearance_collate(config):
    from stlt_tpu_torch.data.appearance import collate_appearance

    return collate_appearance


def _multimodal_dataset(config):
    from stlt_tpu_torch.data.multimodal import MultimodalDataset

    return MultimodalDataset(config)


def _multimodal_collate(config):
    from stlt_tpu_torch.data.multimodal import make_collate_multimodal

    return make_collate_multimodal(config)


datasets_factory = {
    "layout": NativeLayoutDataset,
    "appearance": _appearance_dataset,
    "multimodal": _multimodal_dataset,
}

collaters_factory = {
    "layout": lambda config: functools.partial(collate_layout, dataset_name=config.dataset_name),
    "appearance": _appearance_collate,
    "multimodal": _multimodal_collate,
}
