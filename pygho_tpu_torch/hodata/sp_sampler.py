"""Sparse tuple samplers (port of ``KhopSampler`` and ``I2Sampler`` from
``pygho_tpu/hodata/sp_sampler.py``).

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


def I2Sampler(graph: Graph, hop: int = 3) -> Dict[str, np.ndarray]:
    """Per-edge 3-tuples for I2-GNN (reference SpTupleSampler.py:129-174):
    for each directed edge (u, v), the tuples (u, v, w) for every w within
    ``hop`` of u or of v; feature = (SPD(u, w), SPD(v, w)), an infinite
    distance (w reached from one end only) clamped to ``hop + 2``.

    Besides the fragment :func:`KhopSampler` returns (``tupleid`` of 3
    rows, ``tuplefeat`` ``(nt, 2)``), it gives ``pool2_seg`` ``(nt,)``:
    the index of each tuple's parent edge, the map that pools the
    3-tuples back onto the edge pattern
    (``honn.sp_operator.pool_keys("X", 2)``).  It ascends, as the
    tuples come out edge by edge."""
    dist = _spd_matrix(graph)
    u, v = graph.edge_index[0], graph.edge_index[1]
    within = (dist[u] <= hop) | (dist[v] <= hop)  # (E, n)
    e_idx, w = np.nonzero(within)
    feat = np.stack([dist[u[e_idx], w], dist[v[e_idx], w]], axis=-1)
    feat = np.where(np.isinf(feat), hop + 2, feat).astype(np.int64)
    return {
        "tupleid": np.stack([u[e_idx], v[e_idx], w]).astype(np.int64),
        "tuplefeat": feat,
        "tupleshape": np.array([graph.num_nodes] * 3, dtype=np.int64),
        "pool2_seg": e_idx.astype(np.int64),
    }
