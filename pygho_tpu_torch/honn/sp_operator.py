"""Operators on SparseTensors (port of ``pygho_tpu/honn/sp_operator.py``:
the message passing within and across subgraphs, over the third node of
3-tuples, the 2-FWL product, node message passing, the diagonal, pooling
to dense and sparse outputs, and unpooling).

The precompute-key protocol is kept: each OpMessagePassing module declares
``"{op0}___{op1}___{dim1}___{op2}___{dim2}"``; ``parse_precomputekey``
collects the keys of a built model; the data pipeline stores the key's
triples and row pointer in the datadict (``<key>___acd``,
``<key>___rowptr``), and for training those of the backward roles
(``<key>___acd_dx``, ``<key>___rowptr_dx``, ``<key>___acd_da``,
``<key>___rowptr_da``).  A missing key is an error that points at
preprocessing.

Every tuple message passing runs K1 through ``backend.spspmm`` on its
key's triples; ``OpNodeMessagePassing`` is ``backend.spmm``, a gather and
a segment sum; the pooling, the diagonal and the unpooling are segment
sums and gathers (``SparseTensor``).  A sparse-output pooling reads its
host-built segment map and target pattern from the datadict, under the
keys of :func:`pool_keys`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from ..backend.spmm import spmm
from ..backend.spspmm import spspmm
from ..backend.sptensor import SparseTensor

KEYSEP = "___"

POOL_PREFIX = "pool"  # datadict keys of a precomputed sparse-output pooling


def pool_seg_key(op: str, dims: Union[int, Iterable[int]]) -> str:
    """The datadict key prefix of the pooling of ``dims`` of the tuple
    tensor ``op`` onto a sparse pattern (e.g. ``"Xpool___2"``)."""
    if isinstance(dims, int):
        dims = [dims]
    d = "_".join(str(x) for x in sorted(dims))
    return f"{op}{POOL_PREFIX}{KEYSEP}{d}"


def pool_keys(op: str, dims: Union[int, Iterable[int]]) -> Tuple[str, str]:
    """The datadict keys of that pooling: its tuple-to-target segment map
    (``<prefix>___seg``) and its target pattern (``<prefix>___tarX``)."""
    prefix = pool_seg_key(op, dims)
    return f"{prefix}{KEYSEP}seg", f"{prefix}{KEYSEP}tarX"


def parse_precomputekey(model: nn.Module) -> List[str]:
    """Collect precompute keys from every OpMessagePassing in a model
    (reference SpOperator.py:15-44)."""
    return sorted({mod.precomputekey for mod in model.modules()
                   if isinstance(mod, OpMessagePassing)})


def _fetch_key(datadict: Dict, name: str):
    val = datadict.get(name)
    if val is None:
        raise KeyError(
            f"missing precomputed '{name}'. Run the sparse "
            f"preprocessing with keys=parse_precomputekey(model) and batch "
            f"with SpDataloader.")
    return val


def _fetch(datadict: Dict, key: str, what: str) -> torch.Tensor:
    return _fetch_key(datadict, f"{key}{KEYSEP}{what}")


def fetch_backward_orders(datadict: Dict, key: str):
    """The backward roles' triples and row pointers of ``key``, or None
    where the batch has none (a serving batch)."""
    bwd = tuple(datadict.get(f"{key}{KEYSEP}{what}") for what in
                ("acd_dx", "rowptr_dx", "acd_da", "rowptr_da"))
    return None if any(t is None for t in bwd) else bwd


class OpNodeMessagePassing(nn.Module):
    """Node-level message passing ``out = A @ X`` on a dense ``X``
    (reference SpOperator.py:47-85): ``backend.spmm``."""

    def __init__(self, aggr: str = "sum"):
        super().__init__()
        self.aggr = aggr

    def forward(self, A: SparseTensor, X: torch.Tensor) -> torch.Tensor:
        if A.sparse_dim != 2:
            raise ValueError("OpNodeMessagePassing takes a 2-D A")
        return spmm(A, 1, X, self.aggr)


class OpMessagePassing(nn.Module):
    """Tuple message passing through ``spspmm`` on host-built triples
    (reference SpOperator.py:88-183).  Only sum aggregation is ported."""

    def __init__(self, op0: str = "X", op1: str = "X", dim1: int = 1,
                 op2: str = "A", dim2: int = 0, aggr: str = "sum"):
        super().__init__()
        if aggr != "sum":
            raise NotImplementedError(f"aggr {aggr!r} is not ported yet")
        self.dim1 = dim1
        self.dim2 = dim2
        self.precomputekey = \
            f"{op0}{KEYSEP}{op1}{KEYSEP}{dim1}{KEYSEP}{op2}{KEYSEP}{dim2}"
        self.aggr = aggr

    def forward(self, A: SparseTensor, B: SparseTensor, datadict: Dict,
                tarX: SparseTensor) -> SparseTensor:
        key = self.precomputekey
        return spspmm(A, self.dim1, B, self.dim2, self.aggr,
                      acd=_fetch(datadict, key, "acd"),
                      rowptr=_fetch(datadict, key, "rowptr"),
                      tarX=tarX, bwd=fetch_backward_orders(datadict, key))


class OpMessagePassingOnSubg2D(OpMessagePassing):
    """Message passing within each subgraph: X(i, :) propagated along A
    (reference SpOperator.py:230-277); contraction X[i,k] A[k,j]."""

    def __init__(self, aggr: str = "sum", optuplefeat: str = "X",
                 opadj: str = "A"):
        super().__init__(optuplefeat, optuplefeat, 1, opadj, 0, aggr)

    def forward(self, A: SparseTensor, X: SparseTensor, datadict: Dict,
                tarX: SparseTensor) -> SparseTensor:
        if A.sparse_dim != 2 or X.sparse_dim != 2:
            raise ValueError("OpMessagePassingOnSubg2D takes 2-D A and X")
        return super().forward(X, A, datadict, tarX)


class OpMessagePassingOnSubg3D(OpMessagePassing):
    """Message passing on the third node of 3-tuples: X(i, j, :) propagated
    along A (reference SpOperator.py:280-327); the contraction
    X[i,j,k] A[k,l], key ``X___X___2___A___0``."""

    def __init__(self, aggr: str = "sum", optuplefeat: str = "X",
                 opadj: str = "A"):
        super().__init__(optuplefeat, optuplefeat, 2, opadj, 0, aggr)

    def forward(self, A: SparseTensor, X: SparseTensor, datadict: Dict,
                tarX: SparseTensor) -> SparseTensor:
        if A.sparse_dim != 2 or X.sparse_dim != 3:
            raise ValueError("OpMessagePassingOnSubg3D takes a 2-D A and a "
                             "3-D X")
        return super().forward(X, A, datadict, tarX)


class Op2FWL(OpMessagePassing):
    """2-FWL update ``X <- X1 @ X2`` (reference SpOperator.py:185-227),
    key ``X___X___1___X___0``."""

    def __init__(self, aggr: str = "sum", optuplefeat: str = "X"):
        super().__init__(optuplefeat, optuplefeat, 1, optuplefeat, 0, aggr)

    def forward(self, X1: SparseTensor, X2: SparseTensor, datadict: Dict,
                tarX: SparseTensor) -> SparseTensor:
        if X1.sparse_dim != 2 or X2.sparse_dim != 2:
            raise ValueError("Op2FWL takes 2-D X1 and X2")
        return super().forward(X1, X2, datadict, tarX)


class OpMessagePassingCrossSubg2D(OpMessagePassing):
    """Message passing across subgraphs: the contraction A[i,k] X[k,j]
    (reference SpOperator.py:330-372), key ``X___A___1___X___0``; the
    edge values are K1's first operand."""

    def __init__(self, aggr: str = "sum", optuplefeat: str = "X",
                 opadj: str = "A"):
        super().__init__(optuplefeat, opadj, 1, optuplefeat, 0, aggr)

    def forward(self, A: SparseTensor, X: SparseTensor, datadict: Dict,
                tarX: SparseTensor) -> SparseTensor:
        if A.sparse_dim != 2 or X.sparse_dim != 2:
            raise ValueError("OpMessagePassingCrossSubg2D takes 2-D A and X")
        return super().forward(A, X, datadict, tarX)


class OpDiag(nn.Module):
    """Diagonal extraction to a dense tensor (reference
    SpOperator.py:375-403).  The sparse output is not ported."""

    def __init__(self, dims: Iterable[int], return_sparse: bool = False):
        super().__init__()
        if return_sparse:
            raise NotImplementedError(
                "OpDiag(return_sparse=True) is not ported yet")
        self.dims = sorted(set(dims))

    def forward(self, A: SparseTensor) -> torch.Tensor:
        return A.diag(self.dims)


class OpDiag2D(OpDiag):
    """The diagonal X[i, i] of a 2-D X as a dense ``(n, D)`` tensor."""

    def __init__(self):
        super().__init__([0, 1])

    def forward(self, X: SparseTensor) -> torch.Tensor:
        if X.sparse_dim != 2:
            raise ValueError("OpDiag2D takes a 2-D X")
        return super().forward(X)


class OpPooling(nn.Module):
    """Pool tuple representations over sparse dims (reference
    SpOperator.py:427-467).  To a dense tensor: pooling over dim 1 sums
    segments of sorted ids; over dim 0 the ids (``indices[1]``) are not
    sorted, and in the parity mode the sum goes through the sorted
    ``index_put_`` behind a deterministic ``index_add_``
    (``backend/segment.py``).  With ``return_sparse``, onto the target
    pattern of the datadict through its segment map (the keys of
    :func:`pool_keys`), both built on the host
    (``SparseTensor._reduce_to_sparse``)."""

    def __init__(self, dims: Union[int, Iterable[int]], pool: str = "sum",
                 return_sparse: bool = False, op: str = "X"):
        super().__init__()
        if isinstance(dims, int):
            dims = [dims]
        if pool not in ("sum", "mean"):
            raise NotImplementedError(f"pool {pool!r} is not ported yet")
        self.dims = sorted(set(dims))
        self.pool = pool
        self.return_sparse = return_sparse
        self.op = op

    def forward(self, X: SparseTensor, datadict: Optional[Dict] = None):
        if not self.return_sparse:
            return getattr(X, self.pool)(self.dims)
        datadict = datadict or {}
        seg, tarX = (_fetch_key(datadict, k)
                     for k in pool_keys(self.op, self.dims))
        return getattr(X, self.pool)(
            self.dims, return_sparse=True, seg_ids=seg,
            tar_indices=tarX.indices, tar_nnz=tarX.nnz)


class OpPoolingSubg2D(OpPooling):
    """Pool each subgraph's nodes to its root: dims=[1], dense out
    (reference SpOperator.py:470-493)."""

    def __init__(self, pool: str = "sum"):
        super().__init__(1, pool)

    def forward(self, X: SparseTensor) -> torch.Tensor:
        if X.sparse_dim != 2:
            raise ValueError("OpPoolingSubg2D takes a 2-D X")
        return super().forward(X)


class OpPoolingSubg3D(OpPooling):
    """Pool the third node of 3-tuples onto the (i, j) pair pattern:
    dims=[2], sparse out (reference SpOperator.py:496-519)."""

    def __init__(self, pool: str = "sum", op: str = "X"):
        super().__init__(2, pool, True, op)

    def forward(self, X: SparseTensor, datadict: Dict) -> SparseTensor:
        if X.sparse_dim != 3:
            raise ValueError("OpPoolingSubg3D takes a 3-D X")
        return super().forward(X, datadict)


class OpPoolingCrossSubg2D(OpPooling):
    """Pool the same node across subgraphs: dims=[0], dense out
    (reference SpOperator.py:522-545)."""

    def __init__(self, pool: str = "sum"):
        super().__init__(0, pool)

    def forward(self, X: SparseTensor) -> torch.Tensor:
        if X.sparse_dim != 2:
            raise ValueError("OpPoolingCrossSubg2D takes a 2-D X")
        return super().forward(X)


class OpUnpooling(nn.Module):
    """Broadcast a dense pooled tensor back onto a tuple pattern
    (reference SpOperator.py:548-583): the one sparse dim of ``tarX``
    outside ``dims`` indexes the rows of ``X``.  Unpooling a sparse ``X``
    (the host's ``unpooling_ind`` row map) is not ported."""

    def __init__(self, dims: Union[int, Iterable[int]]):
        super().__init__()
        if isinstance(dims, int):
            dims = [dims]
        self.dims = sorted(set(dims))

    def forward(self, X: torch.Tensor, tarX: SparseTensor) -> SparseTensor:
        if isinstance(X, SparseTensor):
            raise NotImplementedError(
                "unpooling a SparseTensor (the b2a row map) is not ported "
                "yet")
        leftdim = [i for i in range(tarX.sparse_dim) if i not in self.dims]
        if len(leftdim) != 1:
            raise ValueError("can only unpool from one kept dim")
        return tarX.unpooling_fromdense1dim(leftdim[0], X)


class OpUnpoolingSubgNodes2D(OpUnpooling):
    """Copy per-node representations to the same node in all subgraphs
    (reference SpOperator.py:586-592)."""

    def __init__(self):
        super().__init__(1)


class OpUnpoolingRootNodes2D(OpUnpooling):
    """Copy root representations to all tuples of the root's subgraph
    (reference SpOperator.py:595-601)."""

    def __init__(self):
        super().__init__(0)
