from .datasets import synthetic_zinc
from .graph import Graph
from .loader import Buckets, SpDataloader, Sppretransform, add_rowptr
from .sp_data import (batch_to_sparse_dict, collate_sparse, parsekey,
                      sp_datapreprocess)
from .sp_sampler import KhopSampler

__all__ = ["Buckets", "Graph", "KhopSampler", "SpDataloader",
           "Sppretransform", "add_rowptr", "batch_to_sparse_dict",
           "collate_sparse", "parsekey", "sp_datapreprocess",
           "synthetic_zinc"]
