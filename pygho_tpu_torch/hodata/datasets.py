"""Synthetic dataset (port of ``synthetic_zinc`` from
``pygho_tpu/hodata/datasets.py``).

``synthetic_zinc`` is a deterministic molecule-like random graph set with
ZINC statistics (~23 nodes, ~50 directed edges, 21 atom types, 4 bond
types).  The same seed gives the same graphs as the JAX package: both
draw from one ``numpy.random.Generator`` in the same order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .graph import Graph


def _random_molecule(rng: np.random.Generator,
                     n_lo: int = 10, n_hi: int = 32) -> Graph:
    """Connected sparse graph: a random spanning tree + a few extra edges
    (rings), mimicking molecular graphs."""
    n = int(rng.integers(n_lo, n_hi + 1))
    # random tree
    edges = set()
    perm = rng.permutation(n)
    for i in range(1, n):
        j = int(rng.integers(0, i))
        u, v = int(perm[i]), int(perm[j])
        edges.add((u, v))
    # ring-closing extras
    extra = int(rng.integers(1, max(2, n // 6) + 1))
    for _ in range(extra):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.add((int(u), int(v)))
    und = set()
    for u, v in edges:
        und.add((u, v))
        und.add((v, u))
    ei = np.array(sorted(und)).T
    x = rng.integers(0, 21, size=(n, 1))
    ea = rng.integers(1, 4, size=(ei.shape[1],))
    # structural target: cycle rank + mean degree (normalized) — learnable
    # from graph structure alone
    m = ei.shape[1] // 2
    cycles = m - n + 1
    degs = np.bincount(ei[0], minlength=n)
    y = np.array([cycles / 4.0 + degs.mean() / 4.0 + x.mean() / 20.0],
                 dtype=np.float32)
    return Graph(x=x, edge_index=ei, edge_attr=ea, y=y)


def synthetic_zinc(split: str = "train", n_graphs: Optional[int] = None,
                   seed: int = 42) -> List[Graph]:
    sizes = {"train": 1024, "val": 128, "test": 128}
    offs = {"train": 0, "val": 1, "test": 2}
    n = n_graphs if n_graphs is not None else sizes[split]
    rng = np.random.default_rng(seed + 1000 * offs[split])
    return [_random_molecule(rng) for _ in range(n)]
