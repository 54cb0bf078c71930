from .datasets import (SUBSTRUCTURES, count_substructures, load_zinc,
                       synthetic_subgraphcount, synthetic_zinc)
from .graph import Graph
from .loader import (Buckets, MaDataloader, Mapretransform, SpDataloader,
                     Sppretransform, add_rowptr, add_spmamm_triples,
                     padding_stats)
from .ma_data import batch_to_dense_dict, collate_dense, ma_datapreprocess
from .ma_sampler import rdsampler, spdsampler
from .preprocess import ParallelPreprocessDataset
from .sp_data import (batch_to_sparse_dict, collate_sparse, parsekey,
                      sp_datapreprocess)
from .sp_sampler import I2Sampler, KhopSampler

__all__ = ["Buckets", "Graph", "I2Sampler", "KhopSampler", "MaDataloader",
           "Mapretransform", "ParallelPreprocessDataset", "SpDataloader",
           "Sppretransform", "add_rowptr", "add_spmamm_triples",
           "batch_to_dense_dict", "batch_to_sparse_dict", "collate_dense",
           "collate_sparse", "count_substructures", "load_zinc",
           "ma_datapreprocess", "padding_stats", "parsekey", "rdsampler",
           "sp_datapreprocess", "spdsampler", "SUBSTRUCTURES",
           "synthetic_subgraphcount", "synthetic_zinc"]
