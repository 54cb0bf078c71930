"""High-order GNN layers (port of ``NGNNConv``, ``PPGNConv`` and
``NGATConv`` from ``pygho_tpu/honn/conv.py``).  The MLPs are mask-aware:
padded rows and padded dense slots never enter batch-norm statistics."""

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
from .utils import MLP, make_linear

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
