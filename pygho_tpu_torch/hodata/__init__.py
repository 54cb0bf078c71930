from .datasets import load_zinc, synthetic_zinc
from .graph import Graph
from .loader import (Buckets, MaDataloader, Mapretransform, SpDataloader,
                     Sppretransform, add_rowptr, add_spmamm_triples,
                     padding_stats)
from .ma_data import batch_to_dense_dict, collate_dense, ma_datapreprocess
from .ma_sampler import spdsampler
from .preprocess import ParallelPreprocessDataset
from .sp_data import (batch_to_sparse_dict, collate_sparse, parsekey,
                      sp_datapreprocess)
from .sp_sampler import KhopSampler

__all__ = ["Buckets", "Graph", "KhopSampler", "MaDataloader",
           "Mapretransform", "ParallelPreprocessDataset", "SpDataloader",
           "Sppretransform", "add_rowptr", "add_spmamm_triples",
           "batch_to_dense_dict", "batch_to_sparse_dict", "collate_dense",
           "collate_sparse", "load_zinc", "ma_datapreprocess",
           "padding_stats", "parsekey", "sp_datapreprocess", "spdsampler",
           "synthetic_zinc"]
