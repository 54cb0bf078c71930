"""Sparse high-order data: per-graph precompute and static-shape batching
(port of ``pygho_tpu/hodata/sp_data.py``).

Graphs concatenate along the block diagonal (node offsets), index arrays
get the same offsets, and every array is padded to a bucketed size.  The
host side is numpy and gives the same arrays as the JAX package;
:func:`batch_to_sparse_dict` moves a collated batch onto a torch device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import indexing
from ..backend.indexing import PAD_INDEX
from ..backend.sptensor import SparseTensor
from ..honn.sp_operator import KEYSEP
from .graph import Graph

# ----------------------------------------------------------------- parsing


def parseop(op: str) -> str:
    """Map an operator name to the count used for batching offsets
    (reference SpData.py:14-31)."""
    if op[0] == "X":
        return f"num_tuples{op[1:]}"
    if op == "A":
        return "num_edges"
    raise NotImplementedError(f"operator name {op}")


def parsekey(key: str) -> Tuple[str, str, int, str, int]:
    """(reference SpData.py:34-53)"""
    parts = key.split(KEYSEP)
    if len(parts) != 5:
        raise ValueError(f"key format not match: {key}")
    op0, op1, dim1, op2, dim2 = parts
    for op in (op0, op1, op2):
        parseop(op)
    return op0, op1, int(dim1), op2, int(dim2)


def _op_indices(datadict: Dict, op: str) -> np.ndarray:
    return (datadict[f"tupleid{op[1:]}"] if op[0] == "X"
            else datadict["edge_index"])


# ------------------------------------------------------------ per-graph


def sp_datapreprocess(
    graph: Graph,
    tuplesamplers: Sequence[Callable[[Graph], Dict[str, np.ndarray]]],
    annotate: Sequence[str] = ("",),
    keys: Sequence[str] = ("",),
) -> Dict[str, Any]:
    """Run tuple samplers and the spspmm index precompute for one graph
    (reference SpData.py:115-172).  Returns a plain dict of numpy
    arrays."""
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
        datadict[f"tupleid{ann}"] = out["tupleid"]
        datadict[f"tuplefeat{ann}"] = out["tuplefeat"]
        datadict[f"tupleshape{ann}"] = out["tupleshape"]
        datadict[f"num_tuples{ann}"] = out["tupleid"].shape[1]
    for key in keys:
        if not key:
            continue
        op0, op1, dim1, op2, dim2 = parsekey(key)
        tar_ind, bcd = indexing.spspmm_ind(
            _op_indices(datadict, op1), dim1,
            _op_indices(datadict, op2), dim2)
        datadict[f"{key}{KEYSEP}acd"] = indexing.filterind(
            _op_indices(datadict, op0), tar_ind, bcd)
    return datadict


# ------------------------------------------------------------- batching


def _bucket(n: int, minimum: int = 128) -> int:
    return indexing.bucket_size(max(n, 1), minimum)


def collate_sparse(
    datas: List[Dict[str, Any]],
    keys: Sequence[str] = ("",),
    annotate: Sequence[str] = ("",),
    num_graphs: Optional[int] = None,
    buckets: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Concatenate per-graph dicts into one padded batch.

    Graphs are laid out block-diagonally: node ids offset by the cumulative
    node count; tuple ids offset per sparse dim by the same node offsets
    (the reference's __inc__ = tupleshape, SpData.py:60-64); acd triples
    offset by cumulative (num_tuples | num_edges) per row (SpData.py:65-71).

    ``num_graphs`` pads the batch with empty graphs to a static count.
    ``buckets``: optional per-field minimum pad sizes (updated in place by
    the dataloader to keep shapes stable across batches).
    """
    G = len(datas)
    if num_graphs is None:
        num_graphs = G
    if num_graphs < G:
        raise ValueError(f"{G} graphs do not fit a batch of {num_graphs}")
    buckets = buckets if buckets is not None else {}

    node_off = np.cumsum([0] + [d["num_nodes"] for d in datas])
    edge_off = np.cumsum([0] + [d["num_edges"] for d in datas])
    N, E = int(node_off[-1]), int(edge_off[-1])

    def bget(name, n):
        b = max(_bucket(n), buckets.get(name, 0))
        buckets[name] = b
        return b

    N_pad = bget("nodes", N)
    E_pad = bget("edges", E)

    out: Dict[str, np.ndarray] = {}
    # node features
    x = np.concatenate([d["x"] for d in datas], axis=0)
    out["x"] = indexing.pad_values(x, N_pad)
    out["num_nodes"] = np.int32(N)
    out["num_graphs_real"] = np.int32(G)
    # batch vector: node -> graph id; padded nodes -> num_graphs (dropped)
    batch = np.full((N_pad,), num_graphs, dtype=np.int32)
    for g in range(G):
        batch[node_off[g]:node_off[g + 1]] = g
    out["batch"] = batch
    # edges
    ei = np.concatenate(
        [d["edge_index"] + node_off[g] for g, d in enumerate(datas)], axis=1)
    out["edge_index"] = indexing.pad_indices(ei, E_pad)
    if datas[0].get("edge_attr") is not None:
        ea = np.concatenate([d["edge_attr"] for d in datas], axis=0)
        out["edge_attr"] = indexing.pad_values(ea, E_pad)
    out["num_edges"] = np.int32(E)
    # y + graph mask
    if datas[0].get("y") is not None:
        ys = [np.asarray(d["y"]).reshape(-1) for d in datas]
        y = np.stack(ys + [np.zeros_like(ys[0])] * (num_graphs - G))
        out["y"] = y
    out["graph_mask"] = np.arange(num_graphs) < G

    # tuples per annotation
    for ann in annotate:
        tup_off = np.cumsum([0] + [d[f"num_tuples{ann}"] for d in datas])
        T = int(tup_off[-1])
        T_pad = bget(f"tuples{ann}", T)
        tid = np.concatenate(
            [d[f"tupleid{ann}"] + node_off[g]
             for g, d in enumerate(datas)], axis=1)
        out[f"tupleid{ann}"] = indexing.pad_indices(tid, T_pad)
        tf = np.concatenate([d[f"tuplefeat{ann}"] for d in datas], axis=0)
        out[f"tuplefeat{ann}"] = indexing.pad_values(tf, T_pad)
        out[f"num_tuples{ann}"] = np.int32(T)

    # acd triples per key
    counts = {}
    for ann in annotate:
        counts[f"num_tuples{ann}"] = np.cumsum(
            [0] + [d[f"num_tuples{ann}"] for d in datas])
    counts["num_edges"] = edge_off
    for key in keys:
        if not key:
            continue
        op0, op1, _, op2, _ = parsekey(key)
        offs = [counts[parseop(op0)], counts[parseop(op1)],
                counts[parseop(op2)]]
        acds = []
        for g, d in enumerate(datas):
            a = d[f"{key}{KEYSEP}acd"].copy()
            for r in range(3):
                a[r] += offs[r][g]
            acds.append(a)
        acd = np.concatenate(acds, axis=1)
        K_pad = bget(f"acd{key}", acd.shape[1])
        out[f"{key}{KEYSEP}acd"] = indexing.pad_acd(acd, K_pad)
    return out


# ------------------------------------------------------------- to device

# index arrays the device gathers with: int64, the index type of PyTorch
_LONG_INDEX = ("edge_index", "batch")


def _to_tensor(name: str, v: np.ndarray, device: torch.device):
    t = torch.from_numpy(np.ascontiguousarray(v))
    if name in _LONG_INDEX or name.startswith("tupleid"):
        t = t.long()
    return t.to(device)


def batch_to_sparse_dict(batch: Dict[str, Any],
                         annotate: Sequence[str],
                         device: torch.device) -> Dict[str, Any]:
    """Move a collated batch onto ``device`` and wrap its arrays into
    SparseTensors (reference batch2sparse, SpData.py:80-112).

    Produces a datadict with "A" and "X{ann}" SparseTensors.  Every other
    array is passed through as a tensor on ``device`` and every scalar
    count as a Python int.  Index arrays used by PyTorch gathers become
    int64; the kernels' ``___acd``/``___rowptr`` arrays stay int32.
    """
    dd: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            dd[k] = _to_tensor(k, v, device)
        elif isinstance(v, (np.integer, int)) or (
                isinstance(v, np.ndarray) and v.dtype.kind in "iu"):
            dd[k] = int(v)
        else:
            dd[k] = v
    n_pad = batch["x"].shape[0]
    dd["A"] = SparseTensor(
        indices=dd["edge_index"],
        values=dd.get("edge_attr"),
        nnz=int(batch["num_edges"]),
        sparse_shape=(n_pad, n_pad),
    )
    for ann in annotate:
        tid = dd[f"tupleid{ann}"]
        dd[f"X{ann}"] = SparseTensor(
            indices=tid,
            values=dd[f"tuplefeat{ann}"],
            nnz=int(batch[f"num_tuples{ann}"]),
            sparse_shape=(n_pad,) * tid.shape[0],
        )
    return dd
