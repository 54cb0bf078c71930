from .datasets import synthetic_zinc
from .graph import Graph
from .loader import (Buckets, MaDataloader, Mapretransform, SpDataloader,
                     Sppretransform, add_rowptr)
from .ma_data import batch_to_dense_dict, collate_dense, ma_datapreprocess
from .ma_sampler import spdsampler
from .sp_data import (batch_to_sparse_dict, collate_sparse, parsekey,
                      sp_datapreprocess)
from .sp_sampler import KhopSampler

__all__ = ["Buckets", "Graph", "KhopSampler", "MaDataloader",
           "Mapretransform", "SpDataloader", "Sppretransform", "add_rowptr",
           "batch_to_dense_dict", "batch_to_sparse_dict", "collate_dense",
           "collate_sparse", "ma_datapreprocess", "parsekey",
           "sp_datapreprocess", "spdsampler", "synthetic_zinc"]
