"""Sparse tuple sampler (port of ``pygho_tpu/hodata/sp_sampler.py``).

Vectorised with scipy all-pairs shortest paths (BFS distance equals the
unweighted shortest-path distance).  Output index arrays come out
lexicographically sorted by construction (``np.nonzero`` is row-major),
which is the coalesced-order invariant the device relies on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as ssp

from .graph import Graph


def _spd_matrix(graph: Graph) -> np.ndarray:
    """All-pairs unweighted shortest-path distances (float, inf for
    unreachable)."""
    return ssp.csgraph.shortest_path(graph.to_scipy_csr(), directed=False,
                                     unweighted=True,
                                     return_predecessors=False)


def KhopSampler(graph: Graph, hop: int = 2) -> Dict[str, np.ndarray]:
    """Per-root k-hop ego-net tuples (reference SpTupleSampler.py:91-126):
    tuple (i, j) for every j within ``hop`` of root i, feature = SPD(i, j).

    Returns the per-graph datadict fragment:
      tupleid (2, nt) int64 sorted, tuplefeat (nt,) int64, tupleshape (2,).
    """
    dist = _spd_matrix(graph)
    mask = dist <= hop  # root itself included (dist 0)
    ii, jj = np.nonzero(mask)
    feat = dist[ii, jj].astype(np.int64)
    return {
        "tupleid": np.stack([ii, jj]).astype(np.int64),
        "tuplefeat": feat,
        "tupleshape": np.array([graph.num_nodes, graph.num_nodes],
                               dtype=np.int64),
    }
