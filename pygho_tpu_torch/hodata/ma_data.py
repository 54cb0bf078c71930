"""Dense (masked) high-order data: per-graph precompute and pad-and-stack
batching (port of the dense-adjacency parts of
``pygho_tpu/hodata/ma_data.py``).

A batch stacks graphs with per-batch node padding: ``x`` becomes
``(B, n, *f)``, the adjacency a dense ``(B, n, n, *ea)`` and the tuple
features ``(B, n, n, *f)``, each with its validity mask.  The host side
is numpy and gives the same arrays as the JAX package;
:func:`batch_to_dense_dict` moves a collated batch onto a torch device.
The sparse-adjacency ("SD") batches are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..backend import indexing
from ..backend.matensor import MaskedTensor
from .graph import Graph


def ma_datapreprocess(
    graph: Graph,
    tuplesamplers: Sequence[Callable[[Graph], Dict[str, np.ndarray]]],
    annotate: Sequence[str] = ("",),
) -> Dict[str, Any]:
    """Run the tuple samplers for one graph (reference MaData.py:258-299).
    Returns a plain dict of numpy arrays."""
    if len(tuplesamplers) != len(annotate):
        raise ValueError("one annotation per tuple sampler")
    graph = graph.coalesced()
    datadict: Dict[str, Any] = {
        "x": graph.x,
        "edge_index": graph.edge_index,
        "edge_attr": graph.edge_attr,
        "y": graph.y,
        "num_nodes": graph.num_nodes,
        "num_edges": graph.num_edges,
    }
    for ann, sampler in zip(annotate, tuplesamplers):
        out = sampler(graph)
        datadict[f"tuplefeat{ann}"] = out["tuplefeat"]
        datadict[f"tupleshape{ann}"] = out["tupleshape"]
    return datadict


def collate_dense(
    datas: List[Dict[str, Any]],
    annotate: Sequence[str] = ("",),
    num_graphs: Optional[int] = None,
    buckets: Optional[Dict[str, int]] = None,
    denseadj: bool = True,
) -> Dict[str, np.ndarray]:
    """Pad and stack graphs to ``(B, n_pad, ...)`` arrays with validity
    masks.  ``n_pad`` is the largest graph's node count rounded up to a
    bucket of at least 32, and never less than ``buckets["n"]`` (updated
    in place).  ``num_graphs`` pads the batch with empty graphs, whose
    masks are all false."""
    if not denseadj:
        raise NotImplementedError(
            "collate_dense(denseadj=False), the SD mode's sparse "
            "adjacency, is not ported yet")
    G = len(datas)
    if num_graphs is None:
        num_graphs = G
    if num_graphs < G:
        raise ValueError(f"{G} graphs do not fit a batch of {num_graphs}")
    buckets = buckets if buckets is not None else {}
    nmax = max(d["num_nodes"] for d in datas)
    n_pad = max(indexing.bucket_size(nmax, 32), buckets.get("n", 0))
    buckets["n"] = n_pad
    B = num_graphs

    x0 = datas[0]["x"]
    out: Dict[str, np.ndarray] = {}
    x = np.zeros((B, n_pad) + x0.shape[1:], dtype=x0.dtype)
    node_mask = np.zeros((B, n_pad), dtype=bool)
    for g, d in enumerate(datas):
        n = d["num_nodes"]
        x[g, :n] = d["x"]
        node_mask[g, :n] = True
    out["x"] = x
    out["node_mask"] = node_mask
    out["graph_mask"] = np.arange(B) < G

    if datas[0].get("y") is not None:
        ys = [np.asarray(d["y"]).reshape(-1) for d in datas]
        out["y"] = np.stack(ys + [np.zeros_like(ys[0])] * (B - G))

    ea0 = datas[0].get("edge_attr")
    adj = np.zeros((B, n_pad, n_pad)
                   + (ea0.shape[1:] if ea0 is not None else ()),
                   dtype=(ea0.dtype if ea0 is not None else np.float32))
    adj_mask = np.zeros((B, n_pad, n_pad), dtype=bool)
    for g, d in enumerate(datas):
        ei = d["edge_index"]
        adj[g, ei[0], ei[1]] = d["edge_attr"] if ea0 is not None else 1.0
        adj_mask[g, ei[0], ei[1]] = True
    out["A_data"] = adj
    out["A_mask"] = adj_mask

    # tuple features: flat row-major (prod(tupleshape), *f) -> padded dense
    for ann in annotate:
        ndim = len(datas[0][f"tupleshape{ann}"])
        feat0 = datas[0][f"tuplefeat{ann}"]
        featshape = feat0.shape[1:]
        Xd = np.zeros((B,) + (n_pad,) * ndim + featshape, dtype=feat0.dtype)
        Xm = np.zeros((B,) + (n_pad,) * ndim, dtype=bool)
        for g, d in enumerate(datas):
            ts = tuple(int(s) for s in d[f"tupleshape{ann}"])
            sl = (g,) + tuple(slice(0, s) for s in ts)
            Xd[sl] = d[f"tuplefeat{ann}"].reshape(ts + featshape)
            Xm[sl] = True
        out[f"X{ann}_data"] = Xd
        out[f"X{ann}_mask"] = Xm
    return out


def batch_to_dense_dict(batch: Dict[str, Any],
                        annotate: Sequence[str],
                        device: torch.device) -> Dict[str, Any]:
    """Move a collated batch onto ``device`` and wrap its arrays into
    MaskedTensors (reference batch2dense, MaData.py:218-255): ``"x"``,
    ``"A"`` and ``"X{ann}"``.  Every array of the batch is also passed
    through as a tensor on ``device`` under its own name."""
    dd: Dict[str, Any] = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    dd["x"] = MaskedTensor(dd["x"], dd["node_mask"])
    dd["A"] = MaskedTensor(dd["A_data"], dd["A_mask"])
    for ann in annotate:
        dd[f"X{ann}"] = MaskedTensor(dd[f"X{ann}_data"], dd[f"X{ann}_mask"])
    return dd
