from .conv import NGATConv, NGNNConv, PPGNConv
from .ma_operator import parse_spmamm_dims
from .sp_operator import KEYSEP, parse_precomputekey
from .utils import MLP, BatchNorm

__all__ = ["BatchNorm", "KEYSEP", "MLP", "NGATConv", "NGNNConv", "PPGNConv",
           "parse_precomputekey", "parse_spmamm_dims"]
