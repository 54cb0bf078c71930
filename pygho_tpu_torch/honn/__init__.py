from .conv import NGNNConv
from .sp_operator import KEYSEP, parse_precomputekey
from .utils import MLP, BatchNorm

__all__ = ["BatchNorm", "KEYSEP", "MLP", "NGNNConv", "parse_precomputekey"]
