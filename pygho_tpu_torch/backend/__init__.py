from .indexing import PAD_INDEX
from .segment import segment_reduce
from .sptensor import SparseTensor
from .spspmm import spspmm

__all__ = ["PAD_INDEX", "SparseTensor", "segment_reduce", "spspmm"]
