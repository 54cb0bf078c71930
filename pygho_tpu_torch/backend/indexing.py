"""Host-side (numpy) sparse-index engine.

A copy of ``pygho_tpu/backend/indexing.py``: the port must not import
``pygho_tpu`` (its ``__init__`` imports JAX), so it keeps its own.  The
one change is in :func:`spspmm_ind`, which keeps only the numpy join (the
JAX package can swap in a C++ join from ``pygho_tpu/native``; that host
speed-up is not ported yet).

Everything here runs on the CPU in the data pipeline, never on the
device: the index machinery emits fixed-size (bucket-padded) int arrays
that the device consumes with gathers and sorted segment reductions.

Key conventions
---------------
- Indices are int32 on device (int64 on host while hashing).
- A *sorted lexicographic order* (by ``indicehash``) is the canonical
  invariant of every coalesced index array, as in the reference
  (SpTensor.py:167-197).  Sorted order is what lets the device use
  one-pass sorted segment reductions instead of atomics.
- Padding uses ``PAD_INDEX`` (a large positive int32).  Padded entries sort
  after every real entry; the port's segment reductions drop them and its
  gathers clamp them to a valid row.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# Large positive sentinel for padded index slots.  2**30 is far above any
# realistic node/tuple count yet safely inside int32.  Scatters to it are
# dropped; gathers from it clamp to the last row (whose contribution is
# always masked out downstream).
PAD_INDEX: int = 1 << 30


# ---------------------------------------------------------------------------
# hashing (reference SpTensor.py:10-164)
# ---------------------------------------------------------------------------


def indicehash(indice: np.ndarray) -> np.ndarray:
    """Pack ``(sparse_dim, nnz)`` indices into a single int64 key per column,
    preserving lexicographic order.

    Same bit-packing contract as the reference (SpTensor.py:36-44):
    ``63 // sparse_dim`` bits per dimension, which caps the index range at
    2^31 for pairs and 2^21 for triples.
    """
    indice = np.asarray(indice, dtype=np.int64)
    assert indice.ndim == 2
    sparse_dim = indice.shape[0]
    if sparse_dim == 1:
        return indice[0].copy()
    assert np.all(indice >= 0), "negative index cannot be hashed"
    interval = 63 // sparse_dim
    if indice.size:
        assert int(indice.max()) < (1 << interval), (
            "index too large for injective hash")
    out = indice[sparse_dim - 1].copy()
    for i in range(1, sparse_dim):
        out |= indice[sparse_dim - 1 - i] << (interval * i)
    return out


def decodehash(h: np.ndarray, sparse_dim: int) -> np.ndarray:
    """Inverse of :func:`indicehash`."""
    h = np.asarray(h, dtype=np.int64)
    if sparse_dim == 1:
        return h[None].copy()
    assert h.ndim == 1
    interval = 63 // sparse_dim
    mask = (1 << interval) - 1
    shifts = (sparse_dim - 1 - np.arange(sparse_dim, dtype=np.int64))[:, None]
    return (h[None, :] >> (shifts * interval)) & mask


def indicehash_tight(indice: np.ndarray, dimsize: Sequence[int]) -> np.ndarray:
    """Row-major flatten of indices given per-dimension sizes
    (reference SpTensor.py:90-127)."""
    indice = np.asarray(indice, dtype=np.int64)
    dimsize = np.asarray(dimsize, dtype=np.int64)
    assert indice.ndim == 2 and dimsize.ndim == 1
    assert dimsize.shape[0] == indice.shape[0]
    assert int(np.prod(dimsize)) < (1 << 62)
    if indice.shape[0] == 1:
        return indice[0].copy()
    step = np.ones_like(dimsize)
    step[:-1] = np.cumprod(dimsize[1:][::-1])[::-1]
    return (step[:, None] * indice).sum(axis=0)


def decodehash_tight(h: np.ndarray, dimsize: Sequence[int]) -> np.ndarray:
    """Inverse of :func:`indicehash_tight`."""
    h = np.asarray(h, dtype=np.int64)
    dimsize = np.asarray(dimsize, dtype=np.int64)
    if dimsize.shape[0] == 1:
        return h[None].copy()
    step = np.ones_like(dimsize)
    step[:-1] = np.cumprod(dimsize[1:][::-1])[::-1]
    ret = h[None, :] // step[:, None]
    ret[1:] -= ret[:-1] * dimsize[1:, None]
    return ret


# ---------------------------------------------------------------------------
# coalescing (reference SpTensor.py:167-197)
# ---------------------------------------------------------------------------


def coalesce(
    indices: np.ndarray,
    values: Optional[np.ndarray] = None,
    reduce: str = "sum",
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Sort indices lexicographically and merge duplicates, reducing values.

    ``reduce`` in {"sum", "mean", "min", "max"}.  Returns int64 indices in
    canonical sorted order.
    """
    indices = np.asarray(indices, dtype=np.int64)
    h = indicehash(indices)
    uh, inv = np.unique(h, return_inverse=True)
    out_ind = decodehash(uh, indices.shape[0])
    if values is None:
        return out_ind, None
    values = np.asarray(values)
    n = uh.shape[0]
    if reduce == "sum" or reduce == "mean":
        out = np.zeros((n,) + values.shape[1:], dtype=values.dtype)
        np.add.at(out, inv, values)
        if reduce == "mean":
            cnt = np.zeros((n,), dtype=np.int64)
            np.add.at(cnt, inv, 1)
            out = out / np.maximum(cnt, 1).reshape((-1,) + (1,) * (values.ndim - 1))
            out = out.astype(values.dtype)
    elif reduce == "min":
        out = np.full((n,) + values.shape[1:],
                      _dtype_max(values.dtype), dtype=values.dtype)
        np.minimum.at(out, inv, values)
    elif reduce == "max":
        out = np.full((n,) + values.shape[1:],
                      _dtype_min(values.dtype), dtype=values.dtype)
        np.maximum.at(out, inv, values)
    else:
        raise ValueError(f"unknown reduce {reduce}")
    return out_ind, out


def _dtype_max(dt):
    dt = np.dtype(dt)
    return np.iinfo(dt).max if dt.kind in "iu" else np.inf


def _dtype_min(dt):
    dt = np.dtype(dt)
    return np.iinfo(dt).min if dt.kind in "iu" else -np.inf


# ---------------------------------------------------------------------------
# spspmm index precompute (reference Spspmm.py:57-222)
# ---------------------------------------------------------------------------


def spspmm_ind(
    ind1: np.ndarray,
    dim1: int,
    ind2: np.ndarray,
    dim2: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the output index set and the (b, c, d) contraction triples for a
    sparse x sparse contraction eliminating ``dim1`` of ``ind1`` and ``dim2``
    of ``ind2``.

    Matches the reference contract (Spspmm.py:57-143): for every matching
    pair (column c of ind1, column d of ind2) with
    ``ind1[dim1, c] == ind2[dim2, d]``, the product ``val1[c] * val2[d]``
    contributes to output entry ``b``, where the output index is the
    concatenation of ind1 minus dim1 and ind2 minus dim2 (coalesced,
    sorted).  Returns ``(tar_ind int64[sd1+sd2-2, m], bcd int64[3, k])``
    with bcd sorted by b.
    """
    ind1 = np.asarray(ind1, dtype=np.int64)
    ind2 = np.asarray(ind2, dtype=np.int64)
    assert 0 <= dim1 < ind1.shape[0]
    assert 0 <= dim2 < ind2.shape[0]
    k1 = ind1[dim1]
    k2 = ind2[dim2]
    # sort ind2 along the contracted key so each k1 matches a contiguous run
    perm2 = np.argsort(k2, kind="stable")
    k2s = k2[perm2]
    lo = np.searchsorted(k2s, k1, side="left")
    hi = np.searchsorted(k2s, k1, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    # c: index into ind1 columns, one per matched pair
    c = np.repeat(np.arange(ind1.shape[1], dtype=np.int64), cnt)
    # position within each run
    ptr = np.zeros(ind1.shape[1] + 1, dtype=np.int64)
    np.cumsum(cnt, out=ptr[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(ptr[:-1], cnt)
    d_sorted = np.repeat(lo, cnt) + within
    d = perm2[d_sorted]
    rest1 = np.delete(ind1, dim1, axis=0)
    rest2 = np.delete(ind2, dim2, axis=0)
    # pack the per-source partial hashes over the SMALL column sets, then
    # gather + or — ~10x cheaper than hashing the expanded pair arrays
    sd = rest1.shape[0] + rest2.shape[0]
    interval = 63 // sd
    if rest1.size:
        assert int(rest1.max()) < (1 << interval) and             int(rest2.max()) < (1 << interval), "index too large for hash"
    part1 = np.zeros(rest1.shape[1], dtype=np.int64)
    for i in range(rest1.shape[0]):
        part1 |= rest1[i] << (interval * (sd - 1 - i))
    part2 = np.zeros(rest2.shape[1], dtype=np.int64)
    for i in range(rest2.shape[0]):
        part2 |= rest2[i] << (interval * (rest2.shape[0] - 1 - i))
    comb = part1[c] | part2[d]
    uh, b = _unique_inverse_sorted(comb)
    tar_ind = decodehash(uh, sd)
    order = np.argsort(b, kind="stable")
    bcd = np.stack([b[order], c[order], d[order]])
    return tar_ind, bcd


def _unique_inverse_sorted(x: np.ndarray):
    """np.unique(x, return_inverse=True) via one argsort + vectorized
    ranking — several times faster on multi-million-element arrays."""
    order = np.argsort(x, kind="stable")
    sx = x[order]
    if sx.shape[0] == 0:
        return sx, np.zeros(0, dtype=np.int64)
    flags = np.empty(sx.shape[0], dtype=bool)
    flags[0] = True
    np.not_equal(sx[1:], sx[:-1], out=flags[1:])
    ranks = np.cumsum(flags) - 1
    inv = np.empty_like(ranks)
    inv[order] = ranks
    return sx[flags], inv


def spsphadamard_ind(tar_ind: np.ndarray, ind: np.ndarray) -> np.ndarray:
    """For each column i of ``ind`` find its position in the sorted
    ``tar_ind`` (or -1 if absent).  Reference Spspmm.py:146-183."""
    tar_ind = np.asarray(tar_ind, dtype=np.int64)
    ind = np.asarray(ind, dtype=np.int64)
    assert tar_ind.shape[0] == ind.shape[0]
    th = indicehash(tar_ind)
    assert np.all(np.diff(th) > 0), "tar_ind must be sorted & coalesced"
    ih = indicehash(ind)
    pos = np.searchsorted(th, ih, side="right") - 1
    pos = np.maximum(pos, 0)
    b2a = np.where(th[pos] == ih, pos, -1)
    return b2a


def filterind(
    tar_ind: np.ndarray,
    ind: np.ndarray,
    bcd: np.ndarray,
) -> np.ndarray:
    """Restrict bcd triples to output entries present in ``tar_ind``,
    remapping b to positions in tar_ind => acd (reference Spspmm.py:186-222).

    Result is sorted by a (ascending), the invariant the device segment
    reduction relies on.
    """
    b2a = spsphadamard_ind(tar_ind, ind)
    a = b2a[bcd[0]]
    keep = a >= 0
    acd = np.stack([a[keep], bcd[1][keep], bcd[2][keep]])
    order = np.argsort(acd[0], kind="stable")
    return acd[:, order]


# ---------------------------------------------------------------------------
# padding / bucketing (static shapes; no reference counterpart)
# ---------------------------------------------------------------------------


def bucket_size(n: int, min_size: int = 128) -> int:
    """Round ``n`` up to a small set of bucket sizes to bound recompiles
    while keeping padding waste < ~25%: buckets are {2^k, 1.25*2^k, 1.5*2^k,
    1.75*2^k} * min_size."""
    if n <= min_size:
        return min_size
    import math

    p = 1 << (int(n - 1)).bit_length()  # next pow2 >= n
    half = p // 2
    for frac in (1.25, 1.5, 1.75):
        cand = int(half * frac)
        if cand >= n:
            return cand
    return p


def pad_indices(indices: np.ndarray, target_nnz: int) -> np.ndarray:
    """Pad an (sparse_dim, nnz) int array to (sparse_dim, target_nnz) with
    PAD_INDEX columns, returning int32."""
    sd, nnz = indices.shape
    assert target_nnz >= nnz, (target_nnz, nnz)
    out = np.full((sd, target_nnz), PAD_INDEX, dtype=np.int32)
    out[:, :nnz] = indices
    return out


def pad_values(values: np.ndarray, target_nnz: int) -> np.ndarray:
    """Pad an (nnz, *dense) array with zero rows to target_nnz."""
    nnz = values.shape[0]
    assert target_nnz >= nnz
    out = np.zeros((target_nnz,) + values.shape[1:], dtype=values.dtype)
    out[:nnz] = values
    return out


def pad_acd(acd: np.ndarray, target: int) -> np.ndarray:
    """Pad (3, k) acd triples to (3, target).  Padded rows are
    (PAD_INDEX, 0, 0): the gathers read row 0 (valid, cheap) and the scatter
    drops the contribution (out-of-bounds target)."""
    k = acd.shape[1]
    assert target >= k
    out = np.zeros((3, target), dtype=np.int32)
    out[0, k:] = PAD_INDEX
    out[:, :k] = acd
    return out


def ptr2batch(ptr: np.ndarray, dim_size: Optional[int] = None) -> np.ndarray:
    """Expand a pointer array into per-element segment ids:
    out[ptr[i]:ptr[i+1]] = i (reference Spspmm.py:9-31)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    assert ptr.ndim == 1 and ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
    if dim_size is not None:
        assert ptr[-1] == dim_size
    return np.repeat(np.arange(ptr.shape[0] - 1, dtype=np.int64),
                     np.diff(ptr))


def deg2batch(deg: np.ndarray, dim_size: Optional[int] = None) -> np.ndarray:
    """Expand per-segment counts into per-element segment ids
    (reference Spspmm.py:34-54)."""
    deg = np.asarray(deg, dtype=np.int64)
    assert deg.ndim == 1 and np.all(deg >= 0)
    out = np.repeat(np.arange(deg.shape[0], dtype=np.int64), deg)
    if dim_size is not None:
        assert out.shape[0] == dim_size
    return out


def union_ind(indA: np.ndarray, indB: np.ndarray,
              nnz_pad: Optional[int] = None):
    """Host precompute for ``SparseTensor.add(samesparse=False)``
    (reference SpTensor.py:507-514 concatenates and re-coalesces on the
    fly — a dynamic-shape op; here the union pattern and both row maps
    are built once on the host, the device op is one scatter-add).

    ``indA``/``indB``: real (unpadded) index columns, each sorted &
    coalesced.  Returns ``(union_indices_padded, union_nnz, a2u, b2u)``
    where a2u/b2u map each input row to its union position.
    """
    indA = np.asarray(indA, dtype=np.int64)
    indB = np.asarray(indB, dtype=np.int64)
    hA, hB = indicehash(indA), indicehash(indB)
    assert np.all(np.diff(hA) > 0) and np.all(np.diff(hB) > 0), (
        "operands must be sorted & coalesced")
    hU = np.union1d(hA, hB)
    a2u = np.searchsorted(hU, hA).astype(np.int32)
    b2u = np.searchsorted(hU, hB).astype(np.int32)
    indU = decodehash(hU, indA.shape[0])
    nnz = indU.shape[1]
    if nnz_pad is None:
        nnz_pad = bucket_size(nnz)
    return (pad_indices(indU, nnz_pad), nnz, a2u, b2u)


def diag_ind(ind: np.ndarray, dims: Optional[Sequence[int]] = None,
             nnz_pad: Optional[int] = None):
    """Host precompute for sparse-output ``SparseTensor.diag``
    (reference SpTensor.py:354-366): the sub-pattern of rows whose
    ``dims`` indices all coincide, reduced to (kept dims + one diagonal
    dim).  Returns ``(tar_indices_padded, tar_nnz, d2a)`` where
    ``d2a[r]`` is the source row of target row r."""
    ind = np.asarray(ind, dtype=np.int64)
    sd = ind.shape[0]
    if dims is None:
        dims = list(range(sd))
    dims = sorted(set(dims))
    assert len(dims) >= 2
    on = np.ones(ind.shape[1], dtype=bool)
    for d in dims[1:]:
        on &= ind[d] == ind[dims[0]]
    d2a = np.nonzero(on)[0].astype(np.int32)
    keep = [i for i in range(sd) if i not in dims[1:]]
    tar = ind[keep][:, d2a]
    nnz = tar.shape[1]
    if nnz_pad is None:
        nnz_pad = bucket_size(nnz)
    return (pad_indices(tar, nnz_pad), nnz,
            np.concatenate([d2a, np.full(nnz_pad - nnz, -1, np.int32)]))


def unpooling_ind(src_ind: np.ndarray, tar_ind: np.ndarray,
                  dims: Sequence[int]) -> np.ndarray:
    """Host precompute for generic sparse->sparse ``unpooling``
    (reference SpTensor.py:447-468): for each target row, the position
    in ``src_ind`` of the target's indices with ``dims`` removed (-1 if
    absent).  Feed the result to ``SparseTensor.unpooling(b2a=...)``.

    ``src_ind`` real columns only; ``tar_ind`` may be padded (pad
    columns map to -1)."""
    dims = sorted(set([dims] if isinstance(dims, int) else dims))
    tar_ind = np.asarray(tar_ind, dtype=np.int64)
    keep = [i for i in range(tar_ind.shape[0]) if i not in dims]
    real = tar_ind[0] < PAD_INDEX
    sub = tar_ind[keep][:, real]
    b2a = np.full(tar_ind.shape[1], -1, dtype=np.int32)
    # sub rows may repeat (many tuples share one reduced key); search
    # each against the sorted src pattern
    src = np.asarray(src_ind, dtype=np.int64)
    hs = indicehash(src)
    ht = indicehash(sub)
    pos = np.searchsorted(hs, ht, side="right") - 1
    pos = np.maximum(pos, 0)
    b2a[real] = np.where(hs[pos] == ht, pos, -1).astype(np.int32)
    return b2a
