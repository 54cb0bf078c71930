"""Dataset loaders (port of ``synthetic_zinc``, ``load_zinc``,
``count_substructures`` and ``synthetic_subgraphcount`` from
``pygho_tpu/hodata/datasets.py``).

- ``synthetic_zinc`` is a deterministic molecule-like random graph set
  with ZINC statistics (~23 nodes, ~50 directed edges, 21 atom types, 4
  bond types).  The same seed gives the same graphs as the JAX package:
  both draw from one ``numpy.random.Generator`` in the same order.
- ``load_zinc`` reads the real ZINC from its raw files on disk; nothing
  is fetched.
- ``synthetic_subgraphcount`` is the substructure-counting set (random
  graphs, exact counts as targets), the same graphs and targets as the
  JAX package's for a seed.
"""

from __future__ import annotations

import os
import pickle
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


def load_zinc(root: str, split: str = "train",
              subset: bool = True) -> List[Graph]:
    """The real ZINC from its raw files: the files PyG's ``ZINC(root,
    subset=..., split=...)`` downloads, which the reference reads at
    example/zinc.py:96-105.

    Reads ``<root>/raw/{split}.pickle`` (``root`` may also be the ``raw``
    directory itself): a pickled list of molecule dicts with
    ``atom_type`` (n,), ``bond_type`` (n, n), a dense bond-order matrix,
    and the target under the first of ``logP_SA_cycle_normalized``,
    ``logP_SA_cycle`` or ``y``; tensors may be torch or numpy.  With
    ``subset`` (the 12k benchmark subset) the molecules are those of
    ``{split}.index`` (comma-separated indices), or all of them where that
    file is missing.

    Returns the graphs in the shape ``synthetic_zinc`` gives: atom types as
    ``x (n, 1)`` int64, the directed edges of the nonzero bond entries in
    (source, target) order, their bond types as ``edge_attr`` and the
    target as ``y (1,)`` float32.  A molecule of another layout raises a
    KeyError that names it.  (The schema is PyG's ``process()``; the
    fixture under ``tests/fixtures/zinc/raw`` is written to it.)
    """
    raw = root if os.path.exists(os.path.join(root, f"{split}.pickle")) \
        else os.path.join(root, "raw")
    pkl = os.path.join(raw, f"{split}.pickle")
    if not os.path.exists(pkl):
        raise FileNotFoundError(
            f"ZINC raw file {pkl} not found; put the PyG ZINC 'molecules' "
            f"archive's files in {root}/raw (train/val/test .pickle and "
            f".index)")
    with open(pkl, "rb") as f:
        mols = pickle.load(f)
    indices = range(len(mols))
    if subset:
        idx_file = os.path.join(raw, f"{split}.index")
        if os.path.exists(idx_file):
            with open(idx_file) as f:
                indices = [int(t) for t in f.read().strip().rstrip(",")
                           .split(",")]

    def to_np(t):
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)

    graphs = []
    target_keys = ("logP_SA_cycle_normalized", "logP_SA_cycle", "y")
    for i in indices:
        mol = mols[i]
        try:
            x = to_np(mol["atom_type"]).astype(np.int64).reshape(-1, 1)
            adj = to_np(mol["bond_type"])
            tkey = next((k for k in target_keys if k in mol), None)
            if tkey is None:
                raise KeyError(f"none of {target_keys}")
            y = np.asarray(to_np(mol[tkey]),
                           dtype=np.float32).reshape(-1)[:1]
        except KeyError as e:
            keys = sorted(mol) if hasattr(mol, "keys") else type(mol)
            raise KeyError(f"ZINC molecule {i} does not match the expected "
                           f"PyG raw schema (keys {keys}): {e}") from e
        src, dst = np.nonzero(adj)
        order = np.lexsort((dst, src))
        ei = np.stack([src[order], dst[order]]).astype(np.int64)
        ea = adj[ei[0], ei[1]].astype(np.int64)
        graphs.append(Graph(x=x, edge_index=ei, edge_attr=ea, y=y))
    return graphs


SUBSTRUCTURES = ("triangle", "tailed_triangle", "star", "cycle4",
                 "cycle5", "chordal")


def count_substructures(adj: np.ndarray) -> dict:
    """Exact non-induced subgraph counts of the six substructures of the
    subgraph-count benchmarks (Chen et al., "Can Graph Neural Networks
    Count Substructures?"; also the I2-GNN counting suite): triangle,
    tailed triangle, 3-star, 4-cycle, 5-cycle and chordal cycle, in closed
    forms over the adjacency matrix ``adj`` (dense, symmetric, no self
    loops)."""
    A = adj.astype(np.float64)
    d = A.sum(1)
    m = d.sum() / 2.0
    A2 = A @ A
    A3 = A2 @ A
    tri_v = np.diag(A3) / 2.0          # triangles through each vertex
    triangle = tri_v.sum() / 3.0
    tailed = float((tri_v * (d - 2.0)).sum())
    star = float((d * (d - 1.0) * (d - 2.0) / 6.0).sum())
    # closed 4-walks: tr(A^4) = 2 * sum(d^2) - 2m + 8 * C4
    cycle4 = (np.trace(A3 @ A) - 2.0 * (d * d).sum() + 2.0 * m) / 8.0
    cycle5 = (np.trace(A3 @ A2) - 5.0 * np.trace(A3)
              - 5.0 * ((d - 2.0) * np.diag(A3)).sum()) / 10.0
    common = A2 * A                    # common neighbours across each edge
    chordal = float((common * (common - 1.0) / 2.0).sum() / 2.0)
    return {"triangle": float(triangle), "tailed_triangle": tailed,
            "star": star, "cycle4": float(cycle4),
            "cycle5": float(cycle5), "chordal": chordal}


def synthetic_subgraphcount(n_graphs: int = 512, seed: int = 3,
                            n_lo: int = 10, n_hi: int = 30,
                            target: str = "triangle") -> List[Graph]:
    """The substructure-counting set: ``n_graphs`` random graphs of
    ``n_lo`` to ``n_hi`` nodes, each pair joined with a probability drawn
    from [0.1, 0.3) per graph, with their exact substructure counts as
    the regression target.  ``target`` is one of :data:`SUBSTRUCTURES`
    or ``"all"`` (a 6-task regression); the triangle target is divided by
    10, the others by their standard deviation over the set."""
    if target != "all" and target not in SUBSTRUCTURES:
        raise ValueError(f"unknown target {target!r}; "
                         f"choose from {SUBSTRUCTURES + ('all',)}")
    names = SUBSTRUCTURES if target == "all" else (target,)
    rng = np.random.default_rng(seed)
    graphs, counts = [], []
    for _ in range(n_graphs):
        n = int(rng.integers(n_lo, n_hi + 1))
        p = float(rng.uniform(0.1, 0.3))
        adj = np.triu(rng.random((n, n)) < p, 1)
        adj = adj | adj.T
        ei = np.stack(np.nonzero(adj)).astype(np.int64)
        if ei.shape[1] == 0:        # graphs without edges are left out
            continue
        c = count_substructures(adj)
        counts.append([c[k] for k in names])
        graphs.append(Graph(x=np.zeros((n, 1), dtype=np.int64),
                            edge_index=ei, edge_attr=None, y=None))
    counts = np.asarray(counts, dtype=np.float64)
    if target == "triangle":
        scale = np.array([10.0])
    else:
        scale = np.maximum(counts.std(axis=0), 1e-8)
    ys = (counts / scale).astype(np.float32)
    for g, y in zip(graphs, ys):
        g.y = y
    return graphs
