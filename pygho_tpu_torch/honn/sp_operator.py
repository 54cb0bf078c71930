"""Operators on SparseTensors (port of the parts of
``pygho_tpu/honn/sp_operator.py`` that NGNN uses).

The precompute-key protocol is kept: each OpMessagePassing module declares
``"{op0}___{op1}___{dim1}___{op2}___{dim2}"``; ``parse_precomputekey``
collects the keys of a built model; the data pipeline stores the key's
triples and row pointer in the datadict (``<key>___acd``,
``<key>___rowptr``), and for training those of the backward roles
(``<key>___acd_dx``, ``<key>___rowptr_dx``, ``<key>___acd_da``,
``<key>___rowptr_da``).  A missing key is an error that points at
preprocessing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Union

import torch
from torch import nn

from ..backend.spspmm import spspmm
from ..backend.sptensor import SparseTensor

KEYSEP = "___"


def parse_precomputekey(model: nn.Module) -> List[str]:
    """Collect precompute keys from every OpMessagePassing in a model
    (reference SpOperator.py:15-44)."""
    return sorted({mod.precomputekey for mod in model.modules()
                   if isinstance(mod, OpMessagePassing)})


def _fetch(datadict: Dict, key: str, what: str) -> torch.Tensor:
    val = datadict.get(f"{key}{KEYSEP}{what}")
    if val is None:
        raise KeyError(
            f"missing precomputed '{key}{KEYSEP}{what}'. Run the sparse "
            f"preprocessing with keys=parse_precomputekey(model) and batch "
            f"with SpDataloader.")
    return val


def fetch_backward_orders(datadict: Dict, key: str):
    """The backward roles' triples and row pointers of ``key``, or None
    where the batch has none (a serving batch)."""
    bwd = tuple(datadict.get(f"{key}{KEYSEP}{what}") for what in
                ("acd_dx", "rowptr_dx", "acd_da", "rowptr_da"))
    return None if any(t is None for t in bwd) else bwd


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


class OpPooling(nn.Module):
    """Pool tuple representations over sparse dims to a dense tensor
    (reference SpOperator.py:427-467).  Sparse output is not ported."""

    def __init__(self, dims: Union[int, Iterable[int]], pool: str = "sum"):
        super().__init__()
        if isinstance(dims, int):
            dims = [dims]
        if pool not in ("sum", "mean"):
            raise NotImplementedError(f"pool {pool!r} is not ported yet")
        self.dims = sorted(set(dims))
        self.pool = pool

    def forward(self, X: SparseTensor) -> torch.Tensor:
        return getattr(X, self.pool)(self.dims)


class OpPoolingSubg2D(OpPooling):
    """Pool each subgraph's nodes to its root: dims=[1], dense out
    (reference SpOperator.py:470-493)."""

    def __init__(self, pool: str = "sum"):
        super().__init__(1, pool)

    def forward(self, X: SparseTensor) -> torch.Tensor:
        if X.sparse_dim != 2:
            raise ValueError("OpPoolingSubg2D takes a 2-D X")
        return super().forward(X)
