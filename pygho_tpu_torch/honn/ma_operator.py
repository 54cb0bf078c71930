"""Operators on MaskedTensors (port of the parts of
``pygho_tpu/honn/ma_operator.py`` that PPGN in dense mode uses).

Dense message passing is a ``mamamm`` over zero-filled padded tensors: no
index plumbing, and the channel-wise products go to the K5 kernel.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

from torch import nn

from ..backend.mamamm import mamamm
from ..backend.matensor import MaskedTensor


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
