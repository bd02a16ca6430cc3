from .basic import (
    BatchStatNorm,
    Conv1D,
    Dense,
    FrozenBatchNorm,
    dropout,
    lrelu,
    make_norm,
    same_pad,
)
from .decoders import Graphite, inner_product_decoder
from .edge_conv import (
    E2E,
    E2N,
    N2N,
    DeE2E,
    DeE2N,
    DeN2G,
    DeN2N,
    G2NBroadcast,
    N2GAdj,
    N2GPool,
)
from .geometric import (
    GeoGraphConv,
    StructGraphConv,
    gather_nodes,
    knn_dist,
    orientations,
    positional_embedding,
    quaternions,
    rbf_expand,
)
from .graph_conv import GraphConv, GraphConvFull, normalized_graph_conv
from .spatial_conv import (
    SpatialGraphConv,
    SpatialGraphConv3D,
    spatial_graph_conv,
    spatial_graph_conv_3d,
    spatial_graph_conv_3d_dense_oracle,
    spatial_graph_conv_dense_oracle,
)
from ..parallel.hints import constrain, shard_nodes

__all__ = [
    "lrelu", "Dense", "Conv1D", "FrozenBatchNorm", "BatchStatNorm", "make_norm",
    "same_pad", "dropout", "GraphConv", "GraphConvFull", "normalized_graph_conv",
    "SpatialGraphConv", "spatial_graph_conv", "spatial_graph_conv_dense_oracle",
    "SpatialGraphConv3D", "spatial_graph_conv_3d", "spatial_graph_conv_3d_dense_oracle", "E2E",
    "E2N", "N2N", "N2GAdj", "DeN2G", "DeN2N", "DeE2N", "DeE2E", "N2GPool", "G2NBroadcast",
    "GeoGraphConv", "StructGraphConv", "knn_dist", "rbf_expand", "positional_embedding",
    "gather_nodes", "quaternions", "orientations", "inner_product_decoder", "Graphite",
    "constrain", "shard_nodes",
]
