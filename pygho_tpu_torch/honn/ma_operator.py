"""Operators on MaskedTensors (port of ``pygho_tpu/honn/ma_operator.py``).

Dense ("DD") message passing is a ``mamamm`` over zero-filled padded
tensors: no index plumbing.  The channel-wise products, within subgraphs
``(2, 1)`` and across them ``(1, 1)`` (the adjacency read through its
transposed strides), go to the K5 kernel; the node-level product of a
``(b, n, d)`` X and the 3-tuple products are ``torch.einsum``, as the JAX
package leaves them to XLA.  With a sparse batched adjacency ("SD") it is
an ``spmamm``, which takes K1 where the loader built its triples
(``datadict["spmamm___<dim1>___<dim2>___plan"]``) and K5 or a gather
otherwise.  The diagonal, the pooling and the unpooling are the
``MaskedTensor`` methods: views, masked reductions and broadcasts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

from torch import nn

from ..backend.mamamm import mamamm
from ..backend.matensor import MaskedTensor
from ..backend.spmamm import spmamm
from ..backend.sptensor import SparseTensor
from .sp_operator import KEYSEP


class OpNodeMessagePassing(nn.Module):
    """Dense node message passing ``A @ X`` on a node-level ``(b, n, d)``
    X, masked as ``tarX`` (reference MaOperator.py:14-42): an einsum."""

    def forward(self, A: MaskedTensor, X: MaskedTensor,
                tarX: MaskedTensor) -> MaskedTensor:
        if A.masked_dim != 3 or X.masked_dim != 2:
            raise ValueError("OpNodeMessagePassing takes a (b, n, n) A and "
                             "a (b, n) masked X")
        return mamamm(A, 2, X, 1, tarX.mask)


class OpSpNodeMessagePassing(nn.Module):
    """Node message passing on a sparse batched adjacency (reference
    MaOperator.py:45-80): ``spmamm`` with a ``(b, n)`` masked X, which
    takes the densify route (an einsum) or the gather route."""

    def __init__(self, aggr: str = "sum"):
        super().__init__()
        self.aggr = aggr

    def forward(self, A: SparseTensor, X: MaskedTensor,
                tarX: MaskedTensor) -> MaskedTensor:
        if A.sparse_dim != 3 or X.masked_dim != 2:
            raise ValueError("OpSpNodeMessagePassing takes a (b, n, n) A "
                             "and a (b, n) masked X")
        return spmamm(A, 2, X, 1, tarX.mask, self.aggr)


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


class OpMessagePassingOnSubg3D(OpMessagePassing):
    """Message passing on the third node of 3-tuples ``X[b,i,j,k,d]
    A[b,k,l,d]``, masked as ``tarX`` (reference MaOperator.py:204-238): an
    einsum."""

    def __init__(self):
        super().__init__(3, 1)

    def forward(self, A: MaskedTensor, X: MaskedTensor,
                datadict: Optional[Dict] = None,
                tarX: Optional[MaskedTensor] = None) -> MaskedTensor:
        if A.masked_dim != 3 or X.masked_dim != 4:
            raise ValueError("OpMessagePassingOnSubg3D takes a (b, n, n) A "
                             "and a (b, n, n, n) X")
        return super().forward(X, A, tarX)


class OpMessagePassingCrossSubg2D(OpMessagePassing):
    """Cross-subgraph message passing ``A[b,k,i,d] X[b,k,j,d]``, masked as
    ``tarX`` (reference MaOperator.py:240-278): K5 on ``A`` read through
    its transposed strides."""

    def __init__(self):
        super().__init__(1, 1)

    def forward(self, A: MaskedTensor, X: MaskedTensor,
                datadict: Optional[Dict] = None,
                tarX: Optional[MaskedTensor] = None) -> MaskedTensor:
        if A.masked_dim != 3 or X.masked_dim != 3:
            raise ValueError("OpMessagePassingCrossSubg2D takes (b, n, n) "
                             "masked A and X")
        return super().forward(A, X, tarX)


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


class OpSpMessagePassingOnSubg3D(OpSpMessagePassing):
    """Message passing on the third node of 3-tuples on a sparse
    adjacency: ``(dim1, dim2) = (1, 3)``."""

    def __init__(self, aggr: str = "sum"):
        super().__init__(1, 3, aggr)


class OpSpMessagePassingCrossSubg2D(OpSpMessagePassing):
    """Cross-subgraph message passing on a sparse adjacency: ``(dim1,
    dim2) = (1, 1)``."""

    def __init__(self, aggr: str = "sum"):
        super().__init__(1, 1, aggr)


def parse_spmamm_dims(model: nn.Module) -> list:
    """The ``(dim1, dim2)`` pairs of every :class:`OpSpMessagePassing` in
    ``model``, sorted: what ``MaDataloader(plan_dims=...)`` builds the
    fused route's triples for."""
    return sorted({(mod.dim1, mod.dim2) for mod in model.modules()
                   if isinstance(mod, OpSpMessagePassing)})


class OpDiag(nn.Module):
    """The joint diagonal of masked dims (reference MaOperator.py:336-361):
    a view."""

    def __init__(self, dims: Iterable[int]):
        super().__init__()
        self.dims = sorted(set(dims))

    def forward(self, A: MaskedTensor) -> MaskedTensor:
        return A.diag(self.dims)


class OpDiag2D(OpDiag):
    """The diagonal ``X[b, i, i]`` of a (b, n, n) X, a (b, n) masked
    tensor."""

    def __init__(self):
        super().__init__([1, 2])

    def forward(self, X: MaskedTensor) -> MaskedTensor:
        if X.masked_dim != 3:
            raise ValueError("OpDiag2D takes a (b, n, n) masked X")
        return super().forward(X)


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


class OpPoolingSubg3D(OpPooling):
    """Pool the third node of 3-tuples: dim 3 of a (b, n, n, n) X."""

    def __init__(self, pool: str = "sum"):
        super().__init__([3], pool)

    def forward(self, X: MaskedTensor, datadict=None) -> MaskedTensor:
        if X.masked_dim != 4:
            raise ValueError("OpPoolingSubg3D takes a (b, n, n, n) masked X")
        return super().forward(X)


class OpPoolingCrossSubg2D(OpPooling):
    """Pool the same node across subgraphs: dim 1 of a (b, n, n) X."""

    def __init__(self, pool: str = "sum"):
        super().__init__([1], pool)

    def forward(self, X: MaskedTensor, datadict=None) -> MaskedTensor:
        if X.masked_dim != 3:
            raise ValueError("OpPoolingCrossSubg2D takes a (b, n, n) "
                             "masked X")
        return super().forward(X)


class OpUnpooling(nn.Module):
    """Broadcast along new masked dims to ``tarX``'s shape, with its mask
    (reference MaOperator.py:481-511): an ``expand``."""

    def __init__(self, dims: Union[int, Iterable[int]]):
        super().__init__()
        if isinstance(dims, int):
            dims = [dims]
        self.dims = sorted(set(dims))

    def forward(self, X: MaskedTensor, tarX: MaskedTensor) -> MaskedTensor:
        return X.unpooling(self.dims, tarX)


class OpUnpoolingSubgNodes2D(OpUnpooling):
    """A (b, n) tensor onto (b, n, n) along dim 2: ``out[b, i, j] =
    X[b, i]``."""

    def __init__(self):
        super().__init__([2])


class OpUnpoolingRootNodes2D(OpUnpooling):
    """A (b, n) tensor onto (b, n, n) along dim 1: ``out[b, i, j] =
    X[b, j]``."""

    def __init__(self):
        super().__init__([1])
