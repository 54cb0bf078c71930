"""High-order GNN layers (port of ``NGNNConv`` and ``PPGNConv`` from
``pygho_tpu/honn/conv.py``).  The MLPs are mask-aware: padded rows and
padded dense slots never enter batch-norm statistics."""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from ..backend.matensor import MaskedTensor
from ..backend.sptensor import SparseTensor
from . import tensorop as TensorOp
from .utils import MLP

Tensorish = Union[SparseTensor, MaskedTensor]


def _apply(X: Tensorish, lin: MLP) -> Tensorish:
    """tuplewiseapply with the validity mask forwarded to the MLP's norms:
    the row mask of a SparseTensor, the (b, n, n) mask of a
    MaskedTensor."""
    m = X.rowmask if isinstance(X, SparseTensor) else X.mask
    return X.tuplewiseapply(lambda v: lin(v, m))


class NGNNConv(nn.Module):
    """Nested GNN layer: X <- MP_subg2D(A, MLP(X))
    (reference Conv.py:20-58; Zhang & Li, NeurIPS 2021)."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        self.aggr = TensorOp.OpMessagePassingOnSubg2D(mode, aggr,
                                                      optuplefeat, opadj)
        self.lin = MLP(indim, outdim, generator=generator, **mlp)

    def forward(self, A: SparseTensor, X: SparseTensor,
                datadict: Dict) -> SparseTensor:
        tX = _apply(X, self.lin)
        return self.aggr(A, tX, datadict, tX)


class PPGNConv(nn.Module):
    """Provably powerful graph network layer: the 2-FWL product
    MLP1(X) @ MLP2(X) (reference Conv.py:200-236; Maron et al., NeurIPS
    2019).  Only the dense ("DD") mode is ported."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "DD", mlp: dict = {}, optuplefeat: str = "X",
                 *, generator: torch.Generator):
        super().__init__()
        self.op = TensorOp.Op2FWL(mode, aggr, optuplefeat)
        self.lin1 = MLP(indim, outdim, generator=generator, **mlp)
        self.lin2 = MLP(indim, outdim, generator=generator, **mlp)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        return self.op(_apply(X, self.lin1), _apply(X, self.lin2),
                       datadict, X)
