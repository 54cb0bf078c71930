"""Sparse x dense matrix product (port of ``pygho_tpu/backend/spmm.py``).

One gather and one segment reduction, as in the JAX package, which runs
this outside any Pallas kernel: plain PyTorch here as well.
"""

from __future__ import annotations

import torch

from .segment import segment_reduce
from .sptensor import SparseTensor


def spmm(A: SparseTensor, dim1: int, X: torch.Tensor,
         aggr: str = "sum") -> torch.Tensor:
    """Contract ``dim1`` of the 2-D SparseTensor ``A`` with dim 0 of the
    dense ``X``: ``out[tar] = aggr over src of A[tar, src] * X[src]``.

    Returns a dense ``[A.sparse_shape[1 - dim1], *dense]`` tensor.  The
    source index is clamped into ``X``'s rows (JAX clamps a gather; the
    ``PAD_INDEX`` padding rows would be out of range), and the padding
    rows' target ids are out of range, so the reduction drops them.
    """
    if A.sparse_dim != 2:
        raise ValueError("spmm needs a 2-D sparse tensor")
    if dim1 == 0:
        srcind, tarind, tarsize = A.indices[0], A.indices[1], \
            A.sparse_shape[1]
    else:
        srcind, tarind, tarsize = A.indices[1], A.indices[0], \
            A.sparse_shape[0]
    gathered = X[torch.clamp(srcind, max=X.shape[0] - 1)]
    if A.values is None:
        mult = gathered
    else:
        av = A.values
        while av.dim() < gathered.dim():  # scalar edge weights broadcast
            av = av[..., None]
        mult = av * gathered
    return segment_reduce(mult, tarind, tarsize, aggr)
