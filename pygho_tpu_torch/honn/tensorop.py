"""Mode-string dispatch over the operators (port of
``pygho_tpu/honn/tensorop.py``).

Mode strings: the first character is the adjacency's representation, the
second the tuples' ("SS" sparse both, "SD" sparse adjacency with dense
tuples, "DD" dense both); the pooling, diagonal and unpooling operators
take the tuples' character alone ("S" or "D").  Ported:

- ``OpMessagePassingOnSubg2D`` in its three modes ("DD" sums only, as in
  the JAX package) and ``OpPoolingSubg2D`` in both;
- ``Op2FWL`` in "SS" and "DD" (sum only);
- ``OpNodeMessagePassing``, ``OpMessagePassingCrossSubg2D``,
  ``OpMessagePassingOnSubg3D``, ``OpDiag2D``, ``OpPoolingCrossSubg2D``,
  ``OpPoolingSubg3D``, ``OpUnpoolingSubgNodes2D`` and
  ``OpUnpoolingRootNodes2D`` in the sparse modes ("SS", "S").

Their dense and SD modes raise ``NotImplementedError`` (``ROADMAP.md``,
Queue A item 9)."""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from . import ma_operator as MaOperator
from . import sp_operator as SpOperator


def _unported(op: str, mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"{op} in mode {mode!r} is not ported yet (ROADMAP.md, Queue A "
        f"item 9)")


class OpNodeMessagePassing(nn.Module):
    """(reference TensorOp.py:14-65)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum"):
        super().__init__()
        if mode != "SS":
            raise _unported("OpNodeMessagePassing", mode)
        self.mod = SpOperator.OpNodeMessagePassing(aggr)

    def forward(self, A, X):
        return self.mod(A, X)


class Op2FWL(nn.Module):
    """(reference TensorOp.py:68-123)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X"):
        super().__init__()
        if mode == "SS":
            self.mod = SpOperator.Op2FWL(aggr, optuplefeat)
        elif mode == "DD":
            if aggr != "sum":
                raise ValueError(f"only sum aggregation for dense, got "
                                 f"{aggr!r}")
            self.mod = MaOperator.Op2FWL()
        else:
            raise NotImplementedError(f"mode {mode!r} is not ported yet")

    def forward(self, X1, X2, datadict: Optional[Dict] = None, tarX=None):
        return self.mod(X1, X2, datadict, tarX)


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


class OpMessagePassingOnSubg3D(nn.Module):
    """(reference TensorOp.py:190-252)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X", opadj: str = "A"):
        super().__init__()
        if mode != "SS":
            raise _unported("OpMessagePassingOnSubg3D", mode)
        self.mod = SpOperator.OpMessagePassingOnSubg3D(aggr, optuplefeat,
                                                       opadj)

    def forward(self, A, X, datadict: Dict, tarX):
        return self.mod(A, X, datadict, tarX)


class OpMessagePassingCrossSubg2D(nn.Module):
    """(reference TensorOp.py:255-317)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X", opadj: str = "A"):
        super().__init__()
        if mode != "SS":
            raise _unported("OpMessagePassingCrossSubg2D", mode)
        self.mod = SpOperator.OpMessagePassingCrossSubg2D(aggr, optuplefeat,
                                                          opadj)

    def forward(self, A, X, datadict: Dict, tarX):
        return self.mod(A, X, datadict, tarX)


class OpDiag2D(nn.Module):
    """(reference TensorOp.py:320-360)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        if mode != "S":
            raise _unported("OpDiag2D", mode)
        self.mod = SpOperator.OpDiag2D()

    def forward(self, X):
        return self.mod(X)


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


class OpPoolingSubg3D(nn.Module):
    """(reference TensorOp.py:401-420)"""

    def __init__(self, mode: str = "S", pool: str = "sum", op: str = "X"):
        super().__init__()
        if mode != "S":
            raise _unported("OpPoolingSubg3D", mode)
        self.mod = SpOperator.OpPoolingSubg3D(pool, op)

    def forward(self, X, datadict: Dict):
        return self.mod(X, datadict)


class OpPoolingCrossSubg2D(nn.Module):
    """(reference TensorOp.py:423-443)"""

    def __init__(self, mode: str = "S", pool: str = "sum"):
        super().__init__()
        if mode != "S":
            raise _unported("OpPoolingCrossSubg2D", mode)
        self.mod = SpOperator.OpPoolingCrossSubg2D(pool)

    def forward(self, X):
        return self.mod(X)


class OpUnpoolingSubgNodes2D(nn.Module):
    """(reference TensorOp.py:446-471)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        if mode != "S":
            raise _unported("OpUnpoolingSubgNodes2D", mode)
        self.mod = SpOperator.OpUnpoolingSubgNodes2D()

    def forward(self, X, tarX):
        return self.mod(X, tarX)


class OpUnpoolingRootNodes2D(nn.Module):
    """(reference TensorOp.py:474-500)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        if mode != "S":
            raise _unported("OpUnpoolingRootNodes2D", mode)
        self.mod = SpOperator.OpUnpoolingRootNodes2D()

    def forward(self, X, tarX):
        return self.mod(X, tarX)
