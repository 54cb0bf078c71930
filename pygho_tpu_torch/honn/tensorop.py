"""Mode-string dispatch over the operators (port of
``pygho_tpu/honn/tensorop.py``).

Ported: ``OpMessagePassingOnSubg2D`` in its three modes ("SS" sparse
adjacency and tuples, "SD" sparse adjacency with dense tuples, "DD" dense
both, sum aggregation only, as in the JAX package), the dense mode of
``Op2FWL`` (sum only) and ``OpPoolingSubg2D``.  Other modes raise."""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from . import ma_operator as MaOperator
from . import sp_operator as SpOperator


class OpMessagePassingOnSubg2D(nn.Module):
    """(reference TensorOp.py:126-187)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X", opadj: str = "A"):
        super().__init__()
        if mode == "SS":
            self.mod = SpOperator.OpMessagePassingOnSubg2D(aggr, optuplefeat,
                                                           opadj)
        elif mode == "SD":
            self.mod = MaOperator.OpSpMessagePassingOnSubg2D(aggr)
        elif mode == "DD":
            if aggr != "sum":
                raise ValueError(f"only sum aggregation for a dense "
                                 f"adjacency, got {aggr!r}")
            self.mod = MaOperator.OpMessagePassingOnSubg2D()
        else:
            raise NotImplementedError(f"mode {mode!r} is not ported yet")

    def forward(self, A, X, datadict: Dict, tarX):
        return self.mod(A, X, datadict, tarX)


class Op2FWL(nn.Module):
    """(reference TensorOp.py:68-123)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X"):
        super().__init__()
        if mode != "DD":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if aggr != "sum":
            raise ValueError(f"only sum aggregation for dense, got {aggr!r}")
        self.mod = MaOperator.Op2FWL()

    def forward(self, X1, X2, datadict: Optional[Dict] = None, tarX=None):
        return self.mod(X1, X2, datadict, tarX)


class OpPoolingSubg2D(nn.Module):
    """(reference TensorOp.py:363-398)"""

    def __init__(self, mode: str = "S", pool: str = "sum"):
        super().__init__()
        if mode == "S":
            self.mod = SpOperator.OpPoolingSubg2D(pool)
        elif mode == "D":
            self.mod = MaOperator.OpPoolingSubg2D(pool)
        else:
            raise NotImplementedError(f"mode {mode!r} is not ported yet")

    def forward(self, X):
        return self.mod(X)
