from .conv import (DSSGNNConv, GNNAKConv, NGATConv, NGNNConv, PPGNConv,
                   SSWLConv, SUNConv)
from .ma_operator import parse_spmamm_dims
from .sp_operator import KEYSEP, parse_precomputekey
from .utils import MLP, BatchNorm, HeteroLinear

__all__ = ["BatchNorm", "DSSGNNConv", "GNNAKConv", "HeteroLinear", "KEYSEP",
           "MLP", "NGATConv", "NGNNConv", "PPGNConv", "SSWLConv", "SUNConv",
           "parse_precomputekey", "parse_spmamm_dims"]
