from .graphbatch import GraphBatch, from_numpy
from .loaders import load_data_syn, load_dataset
from .spanning_tree import sample_spanning_trees

__all__ = ["GraphBatch", "from_numpy", "load_dataset", "load_data_syn",
           "sample_spanning_trees"]
