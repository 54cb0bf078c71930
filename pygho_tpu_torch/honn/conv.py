"""High-order GNN layers (port of ``pygho_tpu/honn/conv.py``: ``NGNNConv``,
``SSWLConv``, ``DSSGNNConv``, ``PPGNConv``, ``GNNAKConv``, ``SUNConv`` and
``NGATConv``; ``I2Conv`` is not ported).  The MLPs are mask-aware: padded
rows and padded dense slots never enter batch-norm statistics.

SSWL, DSSGNN, GNNAK and SUN run in the sparse mode ("SS") only; their
dense and SD modes raise (``ROADMAP.md``, Queue A item 9).  Module
attributes carry the JAX package's names (``aggr1``, ``lin0``,
``lin1_0`` and so on), so ``weights.load_jax_params`` maps them path for
path."""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from ..backend.matensor import MaskedTensor
from ..backend.sptensor import SparseTensor
from ..kernels.numerics import get_fused_math
from ..kernels.segment_attention import SegmentAttention
from ..kernels.spspmm_sum import to_bf16
from . import tensorop as TensorOp
from .sp_operator import OpMessagePassing, _fetch, fetch_backward_orders
from .utils import MLP, HeteroLinear, make_linear

Tensorish = Union[SparseTensor, MaskedTensor]


def _apply(X: Tensorish, lin: MLP) -> Tensorish:
    """tuplewiseapply with the validity mask forwarded to the MLP's norms:
    the row mask of a SparseTensor, the (b, n, n) mask of a
    MaskedTensor."""
    m = X.rowmask if isinstance(X, SparseTensor) else X.mask
    return X.tuplewiseapply(lambda v: lin(v, m))


class NGNNConv(nn.Module):
    """Nested GNN layer: X <- MP_subg2D(A, MLP(X))
    (reference Conv.py:20-58; Zhang & Li, NeurIPS 2021), in the sparse
    ("SS": K1), dense ("DD": K5) and sparse-adjacency ("SD": K1 or K5,
    ``backend.spmamm``) modes."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        self.aggr = TensorOp.OpMessagePassingOnSubg2D(mode, aggr,
                                                      optuplefeat, opadj)
        self.lin = MLP(indim, outdim, generator=generator, **mlp)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        tX = _apply(X, self.lin)
        return self.aggr(A, tX, datadict, tX)


class SSWLConv(nn.Module):
    """Subgraph WL layer: MLP(cat[X, MP_subg(A, X), MP_cross(A, X)])
    (reference Conv.py:62-103; B. Zhang et al., ICML 2023).  Two K1
    contractions a layer: ``X___X___1___A___0`` and the cross key
    ``X___A___1___X___0``, whose first operand is the edge values."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        self.aggr1 = TensorOp.OpMessagePassingOnSubg2D(mode, aggr,
                                                       optuplefeat, opadj)
        self.aggr2 = TensorOp.OpMessagePassingCrossSubg2D(mode, aggr,
                                                          optuplefeat, opadj)
        self.lin = MLP(3 * indim, outdim, generator=generator, **mlp)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        X1 = self.aggr1(A, X, datadict, X)
        X2 = self.aggr2(A, X, datadict, X)
        return _apply(X.catvalue([X1, X2], True), self.lin)


class DSSGNNConv(nn.Module):
    """ESAN/DSS layer: MLP(cat[MP_subg(A, X), unpool(nodeMP(A,
    pool_cross(X)))]) (reference Conv.py:151-196; Bevilacqua et al., ICLR
    2022).  One K1 contraction a layer; the node message passing is
    ``backend.spmm``."""

    def __init__(self, indim: int, outdim: int, aggr_subg: str = "sum",
                 aggr_global: str = "sum", pool: str = "mean",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        self.aggr_subg = TensorOp.OpMessagePassingOnSubg2D(
            mode, aggr_subg, optuplefeat, opadj)
        self.pool2global = TensorOp.OpPoolingCrossSubg2D(mode[1], pool)
        self.aggr_global = TensorOp.OpNodeMessagePassing(mode, aggr_global)
        self.unpooling2subg = TensorOp.OpUnpoolingRootNodes2D(mode[1])
        self.lin = MLP(2 * indim, outdim, generator=generator, **mlp)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        X1 = self.unpooling2subg(self.aggr_global(A, self.pool2global(X)), X)
        X2 = self.aggr_subg(A, X, datadict, X)
        return _apply(X2.catvalue(X1, True), self.lin)


class PPGNConv(nn.Module):
    """Provably powerful graph network layer: the 2-FWL product
    MLP1(X) @ MLP2(X) (reference Conv.py:200-236; Maron et al., NeurIPS
    2019), in the sparse mode ("SS": K1 on the key ``X___X___1___X___0``,
    both operands tuple values) and the dense one ("DD": K5)."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 *, generator: torch.Generator):
        super().__init__()
        self.op = TensorOp.Op2FWL(mode, aggr, optuplefeat)
        self.lin1 = MLP(indim, outdim, generator=generator, **mlp)
        self.lin2 = MLP(indim, outdim, generator=generator, **mlp)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        return self.op(_apply(X, self.lin1), _apply(X, self.lin2),
                       datadict, X)


class GNNAKConv(nn.Module):
    """GNN-as-kernel layer: MP(A, MLP0(X)), then MLP1(cat[unpool(pool_subg),
    unpool(diag), unpool(pool_cross)]), the last only with ``ctx``
    (reference Conv.py:240-297; Zhao et al., ICLR 2022).  One K1
    contraction a layer."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 pool: str = "mean", mode: str = "SS", mlp0: dict = {},
                 mlp1: dict = {}, ctx: bool = True, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        self.lin0 = MLP(indim, indim, generator=generator, **mlp0)
        self.aggr = TensorOp.OpMessagePassingOnSubg2D(mode, aggr,
                                                      optuplefeat, opadj)
        self.diag = TensorOp.OpDiag2D(mode[1])
        self.pool2subg = TensorOp.OpPoolingSubg2D(mode[1], pool)
        self.unpool4subg = TensorOp.OpUnpoolingSubgNodes2D(mode[1])
        self.ctx = ctx
        if ctx:
            self.pool2node = TensorOp.OpPoolingCrossSubg2D(mode[1], pool)
            self.unpool4rootnode = TensorOp.OpUnpoolingRootNodes2D(mode[1])
        self.lin = MLP(3 * indim if ctx else 2 * indim, outdim,
                       generator=generator, **mlp1)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        X = self.aggr(A, _apply(X, self.lin0), datadict, X)
        X1 = self.unpool4subg(self.diag(X), X)
        X2 = self.unpool4subg(self.pool2subg(X), X)
        if self.ctx:
            X3 = self.unpool4rootnode(self.pool2node(X), X)
            return _apply(X2.catvalue([X1, X3], True), self.lin)
        return _apply(X2.catvalue(X1, True), self.lin)


class SUNConv(nn.Module):
    """SUN layer: seven branches concatenated (7 * indim wide), a
    ``HeteroLinear`` that maps diagonal and off-diagonal tuples with
    weights of their own, and an MLP (reference Conv.py:301-363; Frasca et
    al., NeurIPS 2022).  One K1 contraction a layer."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 pool: str = "mean", mode: str = "SS", mlp0: dict = {},
                 mlp1: dict = {}, optuplefeat: str = "X", opadj: str = "A",
                 *, generator: torch.Generator):
        super().__init__()
        self.lin0 = MLP(indim, indim, generator=generator, **mlp0)
        self.aggr = TensorOp.OpMessagePassingOnSubg2D(mode, aggr,
                                                      optuplefeat, opadj)
        self.diag = TensorOp.OpDiag2D(mode[1])
        self.pool2subg = TensorOp.OpPoolingSubg2D(mode[1], pool)
        self.unpool4subg = TensorOp.OpUnpoolingSubgNodes2D(mode[1])
        self.pool2node = TensorOp.OpPoolingCrossSubg2D(mode[1], pool)
        self.unpool4rootnode = TensorOp.OpUnpoolingRootNodes2D(mode[1])
        self.lin1_0 = HeteroLinear(7 * indim, indim, 2, False,
                                   generator=generator)
        self.lin1_1 = MLP(indim, outdim, generator=generator, **mlp1)

    def forward(self, A: Tensorish, X: Tensorish,
                datadict: Dict) -> Tensorish:
        X4 = self.aggr(A, _apply(X, self.lin0), datadict, X)
        Xdiag = self.diag(X)
        X2 = self.unpool4subg(Xdiag, X)
        X3 = self.unpool4rootnode(Xdiag, X)
        X5 = self.unpool4rootnode(self.pool2node(X), X)
        X6 = self.unpool4subg(self.pool2subg(X), X)
        X7 = self.unpool4rootnode(self.pool2node(X4), X)
        Xc = X.catvalue([X2, X3, X4, X5, X6, X7], True)
        return _apply(Xc.diagonalapply(self.lin1_0), self.lin1_1)


class NGATConv(nn.Module):
    """Attention-based nested-subgraph layer (subgraph GAT), sparse ("SS")
    mode: per-channel scores, a softmax over each target tuple's
    in-neighbourhood, and the weighted sum,

        alpha_{ij<-ik} = softmax_k(att1(X_ik) * attA(A_kj) * att2(X_ij))
        X'_ij          = sum_k alpha * att3(X_ik)

    over the triples of ``X___X___1___A___0``, with ``X = MLP(X)`` first.
    The four projections run on rows, not on gathered triples (they are
    row-wise maps, so they commute with the gathers), and the whole
    score -> softmax -> aggregate chain is K4
    (``kernels/segment_attention.py``), whose softmax takes each row's
    exact maximum as its shift.  Only ``aggr="sum"``, the "SS" mode and an
    adjacency with edge values are ported.

    The projections and K4 run in f32 whatever the MLP's compute dtype (the
    JAX layer's f32 kernels promote a bf16 input), and the result comes
    back in ``X``'s dtype.  In fast mode (``set_fused_math(False)``) K4
    runs its fast variants and, on the card, the projections take bf16
    inputs to f32 products and sums (:func:`fast_projection`), as the JAX
    layer's ``_att_proj`` does on its accelerator; on the CPU they stay
    f32, as the JAX layer's do on the CPU."""

    def __init__(self, indim: int, outdim: int, aggr: str = "sum",
                 mode: str = "SS", mlp: dict = {}, optuplefeat: str = "X",
                 opadj: str = "A", *, generator: torch.Generator):
        super().__init__()
        if mode != "SS":
            raise NotImplementedError(
                f"NGATConv is sparse-only; mode {mode!r} is not ported")
        if aggr != "sum":
            raise NotImplementedError(
                f"NGATConv aggr {aggr!r} is not ported yet")
        self.att1 = make_linear(indim, outdim, generator=generator)
        self.attA = make_linear(indim, outdim, generator=generator)
        self.att2 = make_linear(indim, outdim, generator=generator)
        self.att3 = make_linear(indim, outdim, generator=generator)
        self.lin = MLP(indim, outdim, generator=generator, **mlp)
        # declares the precompute key for parse_precomputekey; the layer
        # reads the key's triples itself
        self.keyop = OpMessagePassing(optuplefeat, optuplefeat, 1, opadj, 0,
                                      aggr)

    def forward(self, A: SparseTensor, X: SparseTensor,
                datadict: Dict) -> SparseTensor:
        if A.values is None:
            raise NotImplementedError(
                "NGATConv needs edge values (attA); an adjacency without "
                "them is not ported")
        tX = _apply(X, self.lin)
        key = self.keyop.precomputekey
        xv = tX.values
        exact = get_fused_math()
        proj = fast_projection if not exact and xv.is_cuda \
            else (lambda lin, x: lin(x))
        out = SegmentAttention.apply(
            proj(self.att1, xv), proj(self.att3, xv),
            proj(self.attA, A.values), proj(self.att2, xv),
            _fetch(datadict, key, "acd"), _fetch(datadict, key, "rowptr"),
            fetch_backward_orders(datadict, key), exact)
        return SparseTensor(indices=tX.indices, values=out.to(xv.dtype),
                            nnz=tX.nnz, sparse_shape=tX.sparse_shape)


def fast_projection(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)`` from bf16 inputs: ``x`` and the weight rounded to bf16,
    their products formed and summed in f32 (TF32 off) and the f32 bias
    added, as ``jnp.dot(x.astype(bf16), W.astype(bf16),
    preferred_element_type=f32) + b`` computes (NGAT's projections under
    fast math).  The products of two bf16 values are exact in f32, so this
    is the bf16 product with an f32 result up to the order of the sum."""
    return torch.nn.functional.linear(to_bf16(x), to_bf16(lin.weight),
                                      lin.bias)
