"""High-order GNN layers (port of ``NGNNConv`` from
``pygho_tpu/honn/conv.py``).  The MLPs are mask-aware: padded rows never
enter batch-norm statistics."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..backend.sptensor import SparseTensor
from . import tensorop as TensorOp
from .utils import MLP


def _apply(X: SparseTensor, lin: MLP) -> SparseTensor:
    """tuplewiseapply with the validity mask forwarded to the MLP's norms."""
    m = X.rowmask
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
