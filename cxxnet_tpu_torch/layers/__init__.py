"""Layer zoo.  Importing this package populates the layer registry."""

from . import common, conv, loss, norm, pairtest, pooling  # noqa: F401
from .base import (Decisions, ForwardContext, Layer, LayerParam, NodeSpec,
                   Params, as_mat, create_layer, get_layer_type,
                   layer_type_name, kPairTestGap, kSharedLayer)
from .loss import LossLayerBase
