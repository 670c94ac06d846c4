"""Model factory of the port (the ``"stlt"`` entry of
``stlt_tpu/models/__init__.py``; the appearance and fusion models are later
slices)."""

from stlt_tpu_torch.models.stlt import Stlt

models_factory = {"stlt": Stlt}
