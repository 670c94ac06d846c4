"""Model factory of the port (``stlt_tpu/models/__init__.py``)."""

from stlt_tpu_torch.models.appearance import Resnet3D, TransformerResnet
from stlt_tpu_torch.models.fusion import (
    CrossAttentionCentralNetFusion,
    CrossAttentionFusion,
    LateConcatenationFusion,
)
from stlt_tpu_torch.models.stlt import Stlt

models_factory = {
    "stlt": Stlt,
    "resnet3d": Resnet3D,
    "resnet3d-transformer": TransformerResnet,
    "lcf": LateConcatenationFusion,
    "caf": CrossAttentionFusion,
    "cacnf": CrossAttentionCentralNetFusion,
}
