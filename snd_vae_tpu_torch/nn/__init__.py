from .basic import (
    BatchStatNorm,
    Conv1D,
    Dense,
    FrozenBatchNorm,
    lrelu,
    make_norm,
    same_pad,
)
from .edge_conv import E2E
from .graph_conv import GraphConv
from .spatial_conv import (
    SpatialGraphConv,
    spatial_graph_conv,
    spatial_graph_conv_dense_oracle,
)

__all__ = [
    "lrelu", "Dense", "Conv1D", "FrozenBatchNorm", "BatchStatNorm", "make_norm",
    "same_pad", "GraphConv", "SpatialGraphConv", "spatial_graph_conv",
    "spatial_graph_conv_dense_oracle", "E2E",
]
