"""Dataset/collate factories of the port (``stlt_tpu/data/__init__.py``):
``"layout"``, ``"appearance"`` and ``"multimodal"``. The appearance modules
(and with them h5py and Pillow) are imported when a factory entry is called.
The native C++ tokenizer is not ported (``ROADMAP.md`` item A10)."""

from __future__ import annotations

import functools

from stlt_tpu_torch.data.layout import LayoutDataset, collate_layout


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
    "layout": LayoutDataset,
    "appearance": _appearance_dataset,
    "multimodal": _multimodal_dataset,
}

collaters_factory = {
    "layout": lambda config: functools.partial(collate_layout, dataset_name=config.dataset_name),
    "appearance": _appearance_collate,
    "multimodal": _multimodal_collate,
}
