"""Dense (masked) high-order data: per-graph precompute and pad-and-stack
batching (port of the dense-adjacency parts of
``pygho_tpu/hodata/ma_data.py``).

A batch stacks graphs with per-batch node padding: ``x`` becomes
``(B, n, *f)``, the adjacency a dense ``(B, n, n, *ea)`` ("DD" mode) or a
batched 3-sparse-dim ``(B, n, n)`` one ("SD" mode, ``denseadj=False``)
and the tuple features ``(B, n, n, *f)``, each with its validity mask.
The host side is numpy and gives the same arrays as the JAX package;
:func:`batch_to_dense_dict` moves a collated batch onto a torch device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..backend import indexing
from ..backend.matensor import MaskedTensor
from ..backend.spmamm import SpmammPlan
from ..backend.sptensor import SparseTensor
from ..honn.sp_operator import KEYSEP
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
    masks are all false.

    ``denseadj=False`` (SD mode) gives the adjacency as a batched
    3-sparse-dim tensor in place of ``A_data``/``A_mask``: ``A_indices``
    (int32 ``(3, E_pad)``, rows ``(graph, src, dst)``, padded with
    ``PAD_INDEX``), ``A_values`` (the edge features, zero-padded) and
    ``A_nnz``, with ``E_pad`` a bucket never less than
    ``buckets["edges"]`` (reference to_sparse_adj, MaData.py:73-106)."""
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
    if denseadj:
        adj = np.zeros((B, n_pad, n_pad)
                       + (ea0.shape[1:] if ea0 is not None else ()),
                       dtype=(ea0.dtype if ea0 is not None else np.float32))
        adj_mask = np.zeros((B, n_pad, n_pad), dtype=bool)
        for g, d in enumerate(datas):
            ei = d["edge_index"]
            adj[g, ei[0], ei[1]] = d["edge_attr"] if ea0 is not None \
                else 1.0
            adj_mask[g, ei[0], ei[1]] = True
        out["A_data"] = adj
        out["A_mask"] = adj_mask
    else:
        E = sum(d["num_edges"] for d in datas)
        E_pad = max(indexing.bucket_size(E), buckets.get("edges", 0))
        buckets["edges"] = E_pad
        inds = np.concatenate(
            [np.concatenate([np.full((1, d["num_edges"]), g, np.int64),
                             d["edge_index"]], axis=0)
             for g, d in enumerate(datas)], axis=1)
        out["A_indices"] = indexing.pad_indices(inds, E_pad)
        if ea0 is not None:
            out["A_values"] = indexing.pad_values(
                np.concatenate([d["edge_attr"] for d in datas], axis=0),
                E_pad)
        out["A_nnz"] = np.int32(E)

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
    ``"A"`` and ``"X{ann}"``; in SD mode ``"A"`` is a SparseTensor, its
    indices int64.  Every array of the batch is also passed through as a
    tensor on ``device`` under its own name.  Where the loader built the
    fused route's triples (``<key>___acd``, ``___rowptr`` and the backward
    roles' ``___acd_dx``, ``___rowptr_dx``, ``___acd_da``,
    ``___rowptr_da``, int32), they are gathered, on ``device``, into one
    ``backend.spmamm.SpmammPlan`` under ``<key>___plan``, where the SD
    operators look for it."""
    dd: Dict[str, Any] = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    dd["x"] = MaskedTensor(dd["x"], dd["node_mask"])
    if "A_data" in batch:
        dd["A"] = MaskedTensor(dd["A_data"], dd["A_mask"])
    else:
        n_pad = batch["x"].shape[1]
        dd["A"] = SparseTensor(indices=dd["A_indices"].long(),
                               values=dd.get("A_values"),
                               nnz=int(batch["A_nnz"]),
                               sparse_shape=(batch["x"].shape[0], n_pad,
                                             n_pad))
    for key in [k[:-len(f"{KEYSEP}acd")] for k in batch
                if k.startswith("spmamm") and k.endswith(f"{KEYSEP}acd")]:
        bwd = tuple(dd.get(f"{key}{KEYSEP}{name}") for name in
                    ("acd_dx", "rowptr_dx", "acd_da", "rowptr_da"))
        dd[f"{key}{KEYSEP}plan"] = SpmammPlan(
            dd[f"{key}{KEYSEP}acd"], dd[f"{key}{KEYSEP}rowptr"],
            None if bwd[0] is None else bwd)
    for ann in annotate:
        dd[f"X{ann}"] = MaskedTensor(dd[f"X{ann}_data"], dd[f"X{ann}_mask"])
    return dd
