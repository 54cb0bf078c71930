"""Mode-string dispatch over the operators (port of
``pygho_tpu/honn/tensorop.py``).

Mode strings: the first character is the adjacency's representation, the
second the tuples' ("SS" sparse both, "SD" sparse adjacency with dense
tuples, "DD" dense both); the pooling, diagonal and unpooling operators
take the tuples' character alone ("S" or "D").  Every operator is ported
in every mode the JAX package has, with its checks: "DD" message passing
aggregates by sum only (it is an einsum or K5), "SD" and "DD" take no
``message_func`` (the sparse mode's is not ported either), and
``Op2FWL`` has no "SD" mode."""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from . import ma_operator as MaOperator
from . import sp_operator as SpOperator


def _dense_sum_only(aggr: str) -> None:
    if aggr != "sum":
        raise ValueError(f"only sum aggregation for a dense adjacency, got "
                         f"{aggr!r}")


def _bad_mode(op: str, mode: str, modes: str) -> ValueError:
    return ValueError(f"{op} has no mode {mode!r}; it takes {modes}")


class OpNodeMessagePassing(nn.Module):
    """(reference TensorOp.py:14-65)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum"):
        super().__init__()
        self.sparse = mode == "SS"
        if mode == "SS":
            self.mod = SpOperator.OpNodeMessagePassing(aggr)
        elif mode == "SD":
            self.mod = MaOperator.OpSpNodeMessagePassing(aggr)
        elif mode == "DD":
            _dense_sum_only(aggr)
            self.mod = MaOperator.OpNodeMessagePassing()
        else:
            raise _bad_mode("OpNodeMessagePassing", mode, "SS, SD or DD")

    def forward(self, A, X):
        return self.mod(A, X) if self.sparse else self.mod(A, X, X)


class Op2FWL(nn.Module):
    """(reference TensorOp.py:68-123)"""

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X"):
        super().__init__()
        if mode == "SS":
            self.mod = SpOperator.Op2FWL(aggr, optuplefeat)
        elif mode == "DD":
            _dense_sum_only(aggr)
            self.mod = MaOperator.Op2FWL()
        else:
            raise NotImplementedError(
                f"Op2FWL has no mode {mode!r}: the JAX package's takes SS "
                f"and DD only")

    def forward(self, X1, X2, datadict: Optional[Dict] = None, tarX=None):
        return self.mod(X1, X2, datadict, tarX)


class _MessagePassing(nn.Module):
    """The dispatch of the three tuple message passings: the sparse
    operator ``SP``, the sparse-adjacency one ``SPMA`` and the dense one
    ``MA``."""

    SP = SPMA = MA = None

    def __init__(self, mode: str = "SS", aggr: str = "sum",
                 optuplefeat: str = "X", opadj: str = "A",
                 message_func=None):
        super().__init__()
        if message_func is not None:
            raise NotImplementedError(
                f"{type(self).__name__}: message_func is not ported "
                f"(the JAX package's SD and DD modes take none)")
        if mode == "SS":
            self.mod = self.SP(aggr, optuplefeat, opadj)
        elif mode == "SD":
            self.mod = self.SPMA(aggr)
        elif mode == "DD":
            _dense_sum_only(aggr)
            self.mod = self.MA()
        else:
            raise _bad_mode(type(self).__name__, mode, "SS, SD or DD")

    def forward(self, A, X, datadict: Dict, tarX):
        return self.mod(A, X, datadict, tarX)


class OpMessagePassingOnSubg2D(_MessagePassing):
    """(reference TensorOp.py:126-187)"""

    SP = SpOperator.OpMessagePassingOnSubg2D
    SPMA = MaOperator.OpSpMessagePassingOnSubg2D
    MA = MaOperator.OpMessagePassingOnSubg2D


class OpMessagePassingOnSubg3D(_MessagePassing):
    """(reference TensorOp.py:190-252)"""

    SP = SpOperator.OpMessagePassingOnSubg3D
    SPMA = MaOperator.OpSpMessagePassingOnSubg3D
    MA = MaOperator.OpMessagePassingOnSubg3D


class OpMessagePassingCrossSubg2D(_MessagePassing):
    """(reference TensorOp.py:255-317)"""

    SP = SpOperator.OpMessagePassingCrossSubg2D
    SPMA = MaOperator.OpSpMessagePassingCrossSubg2D
    MA = MaOperator.OpMessagePassingCrossSubg2D


def _tuple_op(name: str, mode: str, *args):
    """``name`` of the sparse operators for mode "S", of the dense ones
    for "D"."""
    if mode == "S":
        return getattr(SpOperator, name)(*args)
    if mode == "D":
        return getattr(MaOperator, name)(*args)
    raise _bad_mode(name, mode, "S or D")


class OpDiag2D(nn.Module):
    """(reference TensorOp.py:320-360)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        self.mod = _tuple_op("OpDiag2D", mode)

    def forward(self, X):
        return self.mod(X)


class OpPoolingSubg2D(nn.Module):
    """(reference TensorOp.py:363-398)"""

    def __init__(self, mode: str = "S", pool: str = "sum"):
        super().__init__()
        self.mod = _tuple_op("OpPoolingSubg2D", mode, pool)

    def forward(self, X):
        return self.mod(X)


class OpPoolingSubg3D(nn.Module):
    """(reference TensorOp.py:401-420)"""

    def __init__(self, mode: str = "S", pool: str = "sum", op: str = "X"):
        super().__init__()
        self.mod = SpOperator.OpPoolingSubg3D(pool, op) if mode == "S" \
            else _tuple_op("OpPoolingSubg3D", mode, pool)

    def forward(self, X, datadict: Optional[Dict] = None):
        return self.mod(X, datadict)


class OpPoolingCrossSubg2D(nn.Module):
    """(reference TensorOp.py:423-443)"""

    def __init__(self, mode: str = "S", pool: str = "sum"):
        super().__init__()
        self.mod = _tuple_op("OpPoolingCrossSubg2D", mode, pool)

    def forward(self, X):
        return self.mod(X)


class OpUnpoolingSubgNodes2D(nn.Module):
    """(reference TensorOp.py:446-471)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        self.mod = _tuple_op("OpUnpoolingSubgNodes2D", mode)

    def forward(self, X, tarX):
        return self.mod(X, tarX)


class OpUnpoolingRootNodes2D(nn.Module):
    """(reference TensorOp.py:474-500)"""

    def __init__(self, mode: str = "S"):
        super().__init__()
        self.mod = _tuple_op("OpUnpoolingRootNodes2D", mode)

    def forward(self, X, tarX):
        return self.mod(X, tarX)
