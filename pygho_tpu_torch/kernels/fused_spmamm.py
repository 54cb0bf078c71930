"""The host side of the fused route of ``spmamm`` (port of
``spmamm_triples`` from ``pygho_tpu/kernels/fused_spmamm.py``).

The SD mode's contraction (``backend/spmamm.py``)

    out[b, ..., t] += Aval[e] * B[b, ..., s]     for edges e = (b, s -> t)

is a gather-multiply-segment-sum like the sparse mode's, so it runs on
K1 (``kernels/spspmm_sum.py``): the host expands each real edge across
its graph's real root coordinates (the masked axes of B that are neither
the batch nor the contracted one), flattens ``(b, roots..., node)`` to
row ids and emits ``(t, u, v)`` triples sorted by ``t``:

    t = flat output row, u = edge row of A.values, v = flat row of B.

The JAX package then builds its TPU kernel's chunk plans from them
(``build_spmamm_plans``, with an autotuner of the TPU's chunk geometry);
the port needs none of that: K1 reads the triples, their row pointer and
the backward roles' orders (``hodata.loader.row_pointer`` and
``backward_orders``), which ``hodata.MaDataloader(build_plans=True)``
builds.
"""

from __future__ import annotations

import numpy as np

from ..backend.indexing import PAD_INDEX


def spmamm_triples(A_indices: np.ndarray, dim1: int, n_pad: int,
                   node_counts: np.ndarray, n_extra: int) -> np.ndarray:
    """Expand padded batched adjacency indices ``(3, nnz_pad)`` into
    ``(t, u, v)`` triples, sorted by ``(t, u)``; int64 ``(3, k)``, the
    JAX package's arrays exactly.

    ``dim1`` follows ``spmamm``: the adjacency node dim that is contracted
    (1: source = indices[1], target = indices[2]; 2: swapped).
    ``node_counts[g]`` is graph g's real node count: every extra masked
    axis of B ranges over it.  Row ids flatten ``(b, extra..., node)``
    with the contracted or target axis last.
    """
    A_indices = np.asarray(A_indices)
    real = A_indices[0] < PAD_INDEX
    e = np.nonzero(real)[0].astype(np.int64)
    b = A_indices[0][real].astype(np.int64)
    if dim1 == 1:
        s, t = A_indices[1][real].astype(np.int64), \
            A_indices[2][real].astype(np.int64)
    elif dim1 == 2:
        s, t = A_indices[2][real].astype(np.int64), \
            A_indices[1][real].astype(np.int64)
    else:
        raise NotImplementedError("dim1 must be 1 or 2")

    counts = np.asarray(node_counts).astype(np.int64)
    if n_extra == 0:
        pre = b
        U = e
        tt, ss = t, s
    else:
        per = counts[b] ** n_extra
        tot = int(per.sum())
        eidx = np.repeat(np.arange(len(b)), per)
        local = np.arange(tot, dtype=np.int64) - np.repeat(
            np.cumsum(per) - per, per)
        c = counts[b][eidx]
        pre = b[eidx]
        rem = local
        for _ in range(n_extra):
            pre = pre * n_pad + rem % c
            rem = rem // c
        U = e[eidx]
        tt, ss = t[eidx], s[eidx]
    T = pre * n_pad + tt
    V = pre * n_pad + ss
    order = np.lexsort((U, T))
    return np.stack([T, U, V])[:, order]
