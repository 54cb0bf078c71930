"""Mode-string dispatch over the operators (port of the "SS" sparse mode
of ``pygho_tpu/honn/tensorop.py``).  Dense ("DD") and mixed ("SD") modes
are not ported yet and raise."""

from __future__ import annotations

from typing import Dict

from torch import nn

from . import sp_operator as SpOperator


class OpMessagePassingOnSubg2D(nn.Module):
    """(reference TensorOp.py:126-187)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X", opadj: str = "A"):
        super().__init__()
        if mode != "SS":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        self.mod = SpOperator.OpMessagePassingOnSubg2D(aggr, optuplefeat,
                                                       opadj)

    def forward(self, A, X, datadict: Dict, tarX):
        return self.mod(A, X, datadict, tarX)


class OpPoolingSubg2D(nn.Module):
    """(reference TensorOp.py:363-398)"""

    def __init__(self, mode: str = "S", pool: str = "sum"):
        super().__init__()
        if mode != "S":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        self.mod = SpOperator.OpPoolingSubg2D(pool)

    def forward(self, X):
        return self.mod(X)
