from .conv import NGATConv, NGNNConv, PPGNConv
from .sp_operator import KEYSEP, parse_precomputekey
from .utils import MLP, BatchNorm

__all__ = ["BatchNorm", "KEYSEP", "MLP", "NGATConv", "NGNNConv", "PPGNConv",
           "parse_precomputekey"]
