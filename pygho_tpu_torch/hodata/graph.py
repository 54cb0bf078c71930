"""Minimal host-side graph container (port of ``pygho_tpu/hodata/graph.py``).

Plain numpy arrays: the data pipeline carries no framework types until
``batch_to_sparse_dict`` moves a collated batch onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..backend import indexing


@dataclasses.dataclass
class Graph:
    x: np.ndarray                      # (n, *f) node features
    edge_index: np.ndarray             # (2, m) int
    edge_attr: Optional[np.ndarray]    # (m, *) or None
    y: Optional[np.ndarray] = None     # graph-level target
    num_nodes: Optional[int] = None

    def __post_init__(self):
        self.x = np.asarray(self.x)
        self.edge_index = np.asarray(self.edge_index, dtype=np.int64)
        if self.edge_attr is not None:
            self.edge_attr = np.asarray(self.edge_attr)
        if self.y is not None:
            self.y = np.asarray(self.y)
        if self.num_nodes is None:
            self.num_nodes = int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def coalesced(self) -> "Graph":
        """Sort + dedup edges (reference sp_datapreprocess first step,
        hodata/SpData.py:133-135)."""
        ei, ea = indexing.coalesce(self.edge_index, self.edge_attr, "sum")
        return dataclasses.replace(self, edge_index=ei, edge_attr=ea)

    def to_scipy_csr(self):
        import scipy.sparse as ssp

        m = self.edge_index.shape[1]
        return ssp.coo_matrix(
            (np.ones(m), (self.edge_index[0], self.edge_index[1])),
            shape=(self.num_nodes, self.num_nodes)).tocsr()
