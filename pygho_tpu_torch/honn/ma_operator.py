"""Operators on MaskedTensors (port of the parts of
``pygho_tpu/honn/ma_operator.py`` that PPGN and NGNN in the dense modes
use).

Dense ("DD") message passing is a ``mamamm`` over zero-filled padded
tensors: no index plumbing, and the channel-wise products go to the K5
kernel.  With a sparse batched adjacency ("SD") it is an ``spmamm``,
which takes K1 where the loader built its triples
(``datadict["spmamm___<dim1>___<dim2>___plan"]``) and K5 or a gather
otherwise.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

from torch import nn

from ..backend.mamamm import mamamm
from ..backend.matensor import MaskedTensor
from ..backend.spmamm import spmamm
from ..backend.sptensor import SparseTensor
from .sp_operator import KEYSEP


class OpMessagePassing(nn.Module):
    """Dense message passing through ``mamamm`` (reference
    MaOperator.py:83-123)."""

    def __init__(self, dim1: int, dim2: int):
        super().__init__()
        self.dim1 = dim1
        self.dim2 = dim2

    def forward(self, A: MaskedTensor, B: MaskedTensor,
                tarX: MaskedTensor) -> MaskedTensor:
        return mamamm(A, self.dim1, B, self.dim2, tarX.mask, True)


class Op2FWL(OpMessagePassing):
    """2-FWL: ``X <- X1 @ X2``, ``(b,i,k,d) x (b,k,j,d) -> (b,i,j,d)``,
    masked as ``tarX`` (reference MaOperator.py:126-160)."""

    def __init__(self):
        super().__init__(2, 1)

    def forward(self, X1: MaskedTensor, X2: MaskedTensor,
                datadict: Optional[Dict] = None,
                tarX: Optional[MaskedTensor] = None) -> MaskedTensor:
        if X1.masked_dim != 3 or X2.masked_dim != 3:
            raise ValueError("Op2FWL takes (b, n, n) masked X1 and X2")
        return super().forward(X1, X2, tarX)


class OpMessagePassingOnSubg2D(OpMessagePassing):
    """Within-subgraph message passing ``X[b,i,k,d] A[b,k,j,d]``, masked
    as ``tarX`` (reference MaOperator.py:163-202)."""

    def __init__(self):
        super().__init__(2, 1)

    def forward(self, A: MaskedTensor, X: MaskedTensor,
                datadict: Optional[Dict] = None,
                tarX: Optional[MaskedTensor] = None) -> MaskedTensor:
        if A.masked_dim != 3 or X.masked_dim != 3:
            raise ValueError("OpMessagePassingOnSubg2D takes (b, n, n) "
                             "masked A and X")
        return super().forward(X, A, tarX)


class OpSpMessagePassing(nn.Module):
    """Sparse-adjacency message passing ("SD" mode) through ``spmamm``
    (reference MaOperator.py:281-333).  Where the loader shipped the
    fused route's triples (``datadict[self.plankey]``, a
    ``backend.spmamm.SpmammPlan``), the contraction runs on K1."""

    def __init__(self, dim1: int, dim2: int, aggr: str = "sum"):
        super().__init__()
        self.dim1 = dim1
        self.dim2 = dim2
        self.aggr = aggr
        self.plankey = f"spmamm{KEYSEP}{dim1}{KEYSEP}{dim2}{KEYSEP}plan"

    def forward(self, A: SparseTensor, X: MaskedTensor,
                datadict: Optional[Dict] = None,
                tarX: Optional[MaskedTensor] = None) -> MaskedTensor:
        plans = None if datadict is None else datadict.get(self.plankey)
        return spmamm(A, self.dim1, X, self.dim2,
                      None if tarX is None else tarX.mask, self.aggr,
                      plans=plans)


class OpSpMessagePassingOnSubg2D(OpSpMessagePassing):
    """Within-subgraph message passing on a sparse adjacency: ``(dim1,
    dim2) = (1, 2)``."""

    def __init__(self, aggr: str = "sum"):
        super().__init__(1, 2, aggr)


def parse_spmamm_dims(model: nn.Module) -> list:
    """The ``(dim1, dim2)`` pairs of every :class:`OpSpMessagePassing` in
    ``model``, sorted: what ``MaDataloader(plan_dims=...)`` builds the
    fused route's triples for."""
    return sorted({(mod.dim1, mod.dim2) for mod in model.modules()
                   if isinstance(mod, OpSpMessagePassing)})


class OpPooling(nn.Module):
    """Masked pooling over masked dims (reference MaOperator.py:390-402):
    ``pool`` is ``sum``, ``mean``, ``max`` or ``min``."""

    def __init__(self, dims: Union[int, Iterable[int]], pool: str = "sum"):
        super().__init__()
        if isinstance(dims, int):
            dims = [dims]
        if pool not in ("sum", "mean", "max", "min"):
            raise ValueError(f"unknown pool {pool!r}")
        self.dims = sorted(set(dims))
        self.pool = pool

    def forward(self, X: MaskedTensor, datadict=None) -> MaskedTensor:
        return getattr(X, self.pool)(tuple(self.dims), keepdim=False)


class OpPoolingSubg2D(OpPooling):
    """Pool each subgraph's nodes to its root: dim 2 of a (b, n, n) X."""

    def __init__(self, pool: str = "sum"):
        super().__init__([2], pool)

    def forward(self, X: MaskedTensor, datadict=None) -> MaskedTensor:
        if X.masked_dim != 3:
            raise ValueError("OpPoolingSubg2D takes a (b, n, n) masked X")
        return super().forward(X)
