from .conv import (DSSGNNConv, GNNAKConv, I2Conv, NGATConv, NGNNConv,
                   PPGNConv, SSWLConv, SUNConv)
from .ma_operator import parse_spmamm_dims
from .sp_operator import KEYSEP, parse_precomputekey
from .utils import MLP, BatchNorm, HeteroLinear, recalibrate_batchnorm

__all__ = ["BatchNorm", "DSSGNNConv", "GNNAKConv", "HeteroLinear", "I2Conv",
           "KEYSEP", "MLP", "NGATConv", "NGNNConv", "PPGNConv", "SSWLConv",
           "SUNConv", "parse_precomputekey", "parse_spmamm_dims",
           "recalibrate_batchnorm"]
