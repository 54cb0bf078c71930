"""Sparse x sparse contraction on host-built index triples (port of the
sum case of ``spspmm`` in ``pygho_tpu/backend/spspmm.py``).

    out[a] = sum over (a, c, d) of A.values[c] * B.values[d]

onto the target pattern ``tarX``.  The hot loop is the K1 kernel
(``kernels/spspmm_sum.py``), reached through its autograd Function
``SpspmmSum``, so a gradient flows through the kernel's dX and dA roles
on every device.  It needs the triples with the padding stripped and their
row pointer, and for a backward the triples in the backward roles' orders,
all of which the loader builds on the host.  It runs in the math mode of
``kernels.set_fused_math`` and returns values in ``A``'s dtype, as the
JAX operator casts the kernel's f32 result (``honn/sp_operator.py:126``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.numerics import get_fused_math
from ..kernels.spspmm_sum import BackwardOrders, SpspmmSum
from .sptensor import SparseTensor


def spspmm(A: SparseTensor, dim1: int, B: SparseTensor, dim2: int,
           aggr: str = "sum", acd: torch.Tensor = None,
           rowptr: torch.Tensor = None,
           tarX: SparseTensor = None,
           bwd: Optional[BackwardOrders] = None) -> SparseTensor:
    """Contract ``dim1`` of ``A`` with ``dim2`` of ``B`` onto ``tarX``.

    ``acd``: int32 ``(3, k)`` real triples sorted by target row;
    ``rowptr``: their int32 row pointer over ``tarX``'s padded rows.
    ``bwd``: the backward roles' triples and row pointers
    ``(acd_dx, rowptr_dx, acd_da, rowptr_da)``; a backward through the
    result raises without them.  Only the sum of two ``(rows, D)`` value
    arrays is ported.
    """
    if aggr != "sum":
        raise NotImplementedError(f"spspmm aggr {aggr!r} is not ported yet")
    if acd is None or rowptr is None or tarX is None:
        raise ValueError("spspmm needs the host-built acd triples, their "
                         "rowptr and the target pattern tarX")
    if A.values is None or B.values is None or A.values.dim() != 2 \
            or B.values.dim() != 2:
        raise NotImplementedError(
            "spspmm is ported for two (rows, D) value arrays only")
    if rowptr.shape[0] != tarX.nnz_pad + 1:
        raise ValueError(f"rowptr spans {rowptr.shape[0] - 1} rows, tarX "
                         f"has {tarX.nnz_pad}")
    vals = SpspmmSum.apply(A.values, B.values, acd, rowptr, bwd,
                           get_fused_math()).to(A.values.dtype)
    keep_shape = (tuple(A.sparse_shape[:dim1])
                  + tuple(A.sparse_shape[dim1 + 1:])
                  + tuple(B.sparse_shape[:dim2])
                  + tuple(B.sparse_shape[dim2 + 1:]))
    return SparseTensor(indices=tarX.indices, values=vals, nnz=tarX.nnz,
                        sparse_shape=keep_shape)
