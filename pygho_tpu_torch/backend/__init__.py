from .indexing import PAD_INDEX
from .mamamm import mamamm
from .matensor import MaskedTensor, filterinf
from .segment import segment_reduce
from .spmamm import spmamm
from .spmm import spmm
from .sptensor import SparseTensor
from .spspmm import spspmm

__all__ = ["MaskedTensor", "PAD_INDEX", "SparseTensor", "filterinf",
           "mamamm", "segment_reduce", "spmamm", "spmm", "spspmm"]
