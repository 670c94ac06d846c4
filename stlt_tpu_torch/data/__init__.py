"""Dataset/collate factories of the port: the ``"layout"`` entries of
``stlt_tpu/data/__init__.py`` (the native tokenizer is a later slice)."""

from __future__ import annotations

import functools

from stlt_tpu_torch.data.layout import LayoutDataset, collate_layout

datasets_factory = {"layout": LayoutDataset}

collaters_factory = {
    "layout": lambda config: functools.partial(collate_layout, dataset_name=config.dataset_name),
}
