from .graphbatch import GraphBatch, from_numpy
from .loaders import (
    load_data_mnist,
    load_data_protein,
    load_data_scene,
    load_data_syn,
    load_dataset,
)
from .spanning_tree import sample_spanning_tree_adj, sample_spanning_trees
from .synthetic import generate_synthetic, save_synthetic_npy
from .transforms import (
    dropout_edges,
    edge_dropout,
    edge_logit_mask,
    gcn_normalize,
    motif_adj_3d,
    pad_graph,
    pairwise_distances,
    split_edges,
    zero_diagonal,
    zscore,
)

__all__ = [
    "GraphBatch",
    "from_numpy",
    "load_dataset",
    "load_data_syn",
    "load_data_protein",
    "load_data_mnist",
    "load_data_scene",
    "sample_spanning_trees",
    "sample_spanning_tree_adj",
    "generate_synthetic",
    "save_synthetic_npy",
    "gcn_normalize",
    "pairwise_distances",
    "zscore",
    "zero_diagonal",
    "edge_logit_mask",
    "split_edges",
    "edge_dropout",
    "dropout_edges",
    "motif_adj_3d",
    "pad_graph",
]
