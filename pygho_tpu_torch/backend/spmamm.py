"""Sparse x masked-dense product, the SD mode's message passing (port of
``pygho_tpu/backend/spmamm.py``).

``A`` is a 3-sparse-dim batched adjacency ``(b, n, n)``, ``B`` a masked
dense ``(b, n, ..., *dense)``:

    out[b, ..., t] = aggr over edges e = (b, s -> t) of A[e] * B[b, ..., s]

with ``dim1`` the adjacency dim that is contracted and ``dim2`` the
masked dim of ``B`` that it meets.  Three routes, chosen as the JAX
package chooses them (``spmamm.py:120-201``):

- **fused** (sum and mean, per-channel edge values as wide as ``B``'s
  features, the loader's triples in ``plans``): K1
  (``kernels/spspmm_sum.py``) through ``SpspmmSum`` on the triples of
  ``kernels.fused_spmamm.spmamm_triples``, operands in f32, in the math
  mode of ``kernels.get_fused_math()``, as ``_fused_spmamm`` runs its TPU
  kernel; its three roles run in a training step;
- **densify** (sum and mean, a dense adjacency under
  :data:`DENSE_BUDGET_BYTES`, while :func:`set_dense_spmamm` leaves it
  on): the edge values are scattered into a dense ``(b, n, n[, d])`` and
  contracted; per-channel values with a ``(b, n, n, d)`` ``B`` go to K5
  (``ChannelwiseBmm``), scalar values to ``torch.einsum``.  The JAX
  package sends the per-channel case to its kernel on a TPU only and at
  ``d % 128 == 0``; those are the TPU's limits, and the port keeps the
  structural conditions only, as ``backend/mamamm.py`` does;
- **gather** (every other case, and max and min): a gather from ``B``, a
  product with the edge values, the invalid sources filled with the
  value neutral to ``aggr``, and a segment reduction into the targets;
  an infinite value left by max or min (a target with no valid source)
  becomes 0.

The densify scatter and the degree count of ``mean`` are accumulating
``index_put_`` and ``index_add_``, which deterministic algorithms
(``models.serve.set_parity_numerics``) keep in a fixed order on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.channelwise_bmm import ChannelwiseBmm
from ..kernels.numerics import get_fused_math
from ..kernels.spspmm_sum import BackwardOrders, SpspmmSum
from .matensor import MaskedTensor, filterinf
from .segment import segment_reduce
from .sptensor import SparseTensor

_FILL = {"sum": 0.0, "mean": 0.0, "max": -torch.inf, "min": torch.inf}

# the densify route is on by default for sum and mean; the budget caps
# the dense adjacency's bytes, so a giant graph's batch keeps the gather
# route (the JAX package's _DENSE_BUDGET_BYTES)
_DENSE_SPMAMM = True
DENSE_BUDGET_BYTES = 512 * 1024 * 1024


def set_dense_spmamm(flag: bool) -> None:
    """``False`` sends sum and mean without plans to the gather route."""
    global _DENSE_SPMAMM
    _DENSE_SPMAMM = bool(flag)


class SpmammPlan(NamedTuple):
    """What the fused route's K1 reads, on the tensors' device: the
    int32 ``(3, k)`` triples ``(t, u, v)`` sorted by ``t``, their int32
    row pointer over the flat output rows, and the backward roles' orders
    (``None``: a forward only)."""
    acd: torch.Tensor
    rowptr: torch.Tensor
    bwd: Optional[BackwardOrders]


def _dense_spmamm(A: SparseTensor, bidx, taridx, srcidx, n_t: int,
                  n_s: int, tB: torch.Tensor, dim2: int, aggr: str,
                  mask) -> MaskedTensor:
    """``out[b, t] = aggr_s densify(A)[b, t, s] * B[b, s]``, with ``tB``
    the zero-filled ``B`` moved to ``(b, s, ...)``."""
    bsz, k = A.sparse_shape[0], A.nnz
    vals = torch.ones(A.nnz_pad, dtype=tB.dtype, device=tB.device) \
        if A.values is None else A.values
    # the real entries only: the padding rows (PAD_INDEX) would fall
    # outside the dense adjacency, where the JAX scatter drops them
    at = (bidx[:k], taridx[:k], srcidx[:k])
    dense = torch.zeros((bsz, n_t, n_s) + tuple(vals.shape[1:]),
                        dtype=vals.dtype, device=vals.device) \
        .index_put(at, vals[:k], accumulate=True)
    if vals.dim() == 1:
        out = torch.einsum("bts,bs...->bt...", dense.float(),
                           tB.float()).to(tB.dtype)
    elif tB.dim() == 4 and dense.shape == tB.shape:
        # per-channel edge values on a (b, n, n, d) B: K5
        if dense.dtype != tB.dtype:
            dense, tB = dense.float(), tB.float()
        out = ChannelwiseBmm.apply(dense, tB).to(tB.dtype)
    else:
        out = torch.einsum("btsd,bs...d->bt...d", dense, tB)
    if aggr == "mean":
        deg = torch.zeros((bsz, n_t), dtype=out.dtype, device=out.device) \
            .index_put(at[:2], torch.ones(k, dtype=out.dtype,
                                          device=out.device),
                       accumulate=True).clamp_min(1.0)
        out = out / deg.reshape(tuple(deg.shape) + (1,) * (out.dim() - 2))
    return MaskedTensor(out.movedim(1, dim2), mask)


def _fused_spmamm(A: SparseTensor, dim1: int, B: MaskedTensor, dim2: int,
                  mask, aggr: str, plans: SpmammPlan) -> MaskedTensor:
    """K1 on the loader's triples: ``B``'s contracted dim moved last and
    flattened to rows, the edge values as K1's ``U`` and ``B``'s rows as
    its ``V``, both in f32; the result in ``B``'s dtype."""
    bsz, n = A.sparse_shape[0], B.data.shape[dim2]
    md = B.masked_dim
    perm = B.fill_masked(0.0).movedim(dim2, md - 1)
    dense_shape = tuple(perm.shape[md:])
    flat = perm.reshape((-1,) + dense_shape)
    rows = flat.shape[0]
    if plans.rowptr.shape[0] != rows + 1:
        raise ValueError(f"the plan's row pointer spans "
                         f"{plans.rowptr.shape[0] - 1} rows, B has {rows}")
    out_flat = SpspmmSum.apply(A.values.float().contiguous(),
                               flat.float().contiguous(), plans.acd,
                               plans.rowptr, plans.bwd, get_fused_math())
    out = out_flat.reshape(tuple(perm.shape[:md]) + dense_shape) \
        .to(B.data.dtype).movedim(md - 1, dim2)
    if aggr == "mean":
        taridx = A.indices[2] if dim1 == 1 else A.indices[1]
        bidx = A.indices[0]
        ids = torch.where(A.rowmask,
                          bidx.clamp(max=bsz - 1) * n
                          + taridx.clamp(max=n - 1), bsz * n)
        deg = segment_reduce(torch.ones(ids.shape[0], dtype=out.dtype,
                                        device=out.device), ids, bsz * n,
                             "sum")
        shape = [1] * out.dim()
        shape[0], shape[dim2] = bsz, n
        out = out / deg.reshape(bsz, n).clamp_min(1.0).reshape(shape)
    return MaskedTensor(out, mask if mask is not None else B.mask)


def spmamm(A: SparseTensor, dim1: int, B: MaskedTensor, dim2: int,
           mask: Optional[torch.Tensor] = None, aggr: str = "sum",
           plans: Optional[SpmammPlan] = None) -> MaskedTensor:
    """``out[b, i] = aggr_j A[b, i, j] * B[b, j]``: ``dim1`` selects which
    of ``A``'s node dims is contracted, ``dim2`` ``B``'s contracted masked
    dim; the result carries ``mask`` (``B``'s where None).  ``plans``
    (the loader's :class:`SpmammPlan`) routes sum and mean with
    per-channel edge values through K1."""
    if A.sparse_dim != 3:
        raise ValueError("A must be a (batch, n, n) sparse tensor")
    if aggr not in _FILL:
        raise ValueError(f"unknown aggr {aggr!r}")
    if (plans is not None and aggr in ("sum", "mean")
            and A.values is not None and A.values.dim() == 2
            and B.dense_dim == 1
            and A.values.shape[1] == B.data.shape[-1]
            and A.values.dtype in (torch.float32, torch.bfloat16)
            and B.data.dtype in (torch.float32, torch.bfloat16)):
        return _fused_spmamm(A, dim1, B, dim2, mask, aggr, plans)
    bsz = A.sparse_shape[0]
    if dim1 == 1:
        n = A.sparse_shape[2]
        bidx, srcidx, taridx = A.indices[0], A.indices[1], A.indices[2]
    elif dim1 == 2:
        n = A.sparse_shape[1]
        bidx, srcidx, taridx = A.indices[0], A.indices[2], A.indices[1]
    else:
        raise NotImplementedError("dim1 must be 1 or 2")

    n_s = A.sparse_shape[1] if dim1 == 1 else A.sparse_shape[2]
    if _DENSE_SPMAMM and aggr in ("sum", "mean"):
        vshape = () if A.values is None else tuple(A.values.shape[1:])
        itemsize = 4 if A.values is None else A.values.element_size()
        nbytes = bsz * n * n_s * itemsize
        for s in vshape:
            nbytes *= s
        vec_ok = (len(vshape) == 1 and B.dense_dim == 1
                  and vshape[0] == B.data.shape[-1])
        if (len(vshape) == 0 or vec_ok) and nbytes <= DENSE_BUDGET_BYTES:
            tBf = B.fill_masked(0.0).movedim(dim2, 1)
            return _dense_spmamm(A, bidx, taridx, srcidx, n, n_s, tBf,
                                 dim2, aggr,
                                 mask if mask is not None else B.mask)

    tB = B.data.movedim(dim2, 1)
    tBmask = B.mask.movedim(dim2, 1)
    cb = bidx.clamp(max=tB.shape[0] - 1)
    cs = srcidx.clamp(max=tB.shape[1] - 1)
    gathered = tB[cb, cs]
    valid = tBmask[cb, cs]
    if A.values is not None:
        # A's edge values broadcast over any extra masked dims of B
        av = A.values
        extra = gathered.dim() - av.dim()
        av = av.reshape(tuple(av.shape[:1]) + (1,) * extra
                        + tuple(av.shape[1:]))
        gathered = av * gathered
    vmask = valid.reshape(tuple(valid.shape)
                          + (1,) * (gathered.dim() - valid.dim()))
    gathered = torch.where(vmask, gathered,
                           torch.full((), _FILL[aggr], dtype=gathered.dtype,
                                      device=gathered.device))
    # flat (b * n) targets; padded entries of A go past the last and drop
    tar = torch.where(A.rowmask, cb * n + taridx.clamp(max=n - 1), bsz * n)
    out = segment_reduce(gathered, tar, bsz * n, aggr)
    out = out.reshape((bsz, n) + tuple(out.shape[1:])).movedim(1, dim2)
    if aggr in ("max", "min"):
        out = filterinf(out, 0.0)
    return MaskedTensor(out, mask if mask is not None else B.mask)
