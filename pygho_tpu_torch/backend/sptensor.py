"""SparseTensor: a batched-COO sparse tensor with padded rows (port of a
subset of ``pygho_tpu/backend/sptensor.py``).

- ``indices``: ``int64[sparse_dim, nnz_pad]``, lexicographically sorted and
  coalesced; padding columns hold ``PAD_INDEX``.
- ``values``: ``[nnz_pad, *dense]`` or None.  Padding rows are kept at 0 by
  :meth:`tuplewiseapply`, so sums and means over rows stay exact.
- ``nnz``: the true count, a Python int.
- ``sparse_shape``: the padded sparse extents.

All coalescing and sorting happens on the host (``backend.indexing``); the
methods here are gathers and segment reductions on the tensors' device.
A gather clamps its index into range, as JAX clamps an out-of-range gather
index (``PAD_INDEX`` padding rows), and the rows it fills for padding are
re-zeroed afterwards.
The SD mode's batched adjacency is a 3-sparse-dim tensor ``(b, n, n)``
(``hodata.collate_dense(denseadj=False)``): its encoder runs through
:meth:`tuplewiseapply`, and ``backend.spmamm`` reads :attr:`rowmask`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence, Tuple, Union

import torch

from .segment import segment_reduce


def _expand_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a [n] bool mask to broadcast against [n, *dense]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    indices: torch.Tensor              # int64[sparse_dim, nnz_pad]
    values: Optional[torch.Tensor]     # [nnz_pad, *dense] | None
    nnz: int                           # true non-zero count
    sparse_shape: Tuple[int, ...]      # padded sparse extents

    @property
    def sparse_dim(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.indices.shape[1]

    @property
    def rowmask(self) -> torch.Tensor:
        """bool[nnz_pad]: True for real entries."""
        return torch.arange(self.nnz_pad, device=self.indices.device) \
            < self.nnz

    def tuplewiseapply(self, func: Callable[[torch.Tensor], torch.Tensor]
                       ) -> "SparseTensor":
        """Apply ``func`` over the value rows (reference
        SpTensor.py:491-496).  Padding rows are re-zeroed afterwards, so
        that a function with a bias never leaks into later sums."""
        nvalues = func(self.values)
        nvalues = torch.where(_expand_mask(self.rowmask, nvalues.dim()),
                              nvalues, torch.zeros((), dtype=nvalues.dtype,
                                                   device=nvalues.device))
        return dataclasses.replace(self, values=nvalues)

    def diagonalapply(self, func: Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]) -> "SparseTensor":
        """Apply ``func(values, is_diagonal)``, ``is_diagonal`` int32
        ``[nnz_pad]`` (1 where ``indices[0] == indices[1]``), and re-zero
        the padding rows (reference SpTensor.py:498-505; 2-D only)."""
        if self.sparse_dim != 2:
            raise ValueError("diagonalapply is only defined for 2-D tensors")
        isdiag = (self.indices[0] == self.indices[1]).to(torch.int32)
        return self.tuplewiseapply(lambda v: func(v, isdiag))

    def add(self, tarX: "SparseTensor", samesparse: bool) -> "SparseTensor":
        """Add two SparseTensors of one pattern (reference
        SpTensor.py:507-514).  Only ``samesparse=True`` is ported."""
        if not samesparse:
            raise NotImplementedError(
                "SparseTensor.add(samesparse=False) is not ported yet")
        return dataclasses.replace(self, values=self.values + tarX.values)

    def catvalue(self, tarXs: Union["SparseTensor", Iterable["SparseTensor"]],
                 samesparse: bool) -> "SparseTensor":
        """Concatenate values along the last dense dim (reference
        SpTensor.py:516-524); the patterns must be the same."""
        if not samesparse:
            raise ValueError("catvalue needs tensors of one sparsity "
                             "pattern (samesparse=True)")
        if isinstance(tarXs, SparseTensor):
            tarXs = [tarXs]
        values = torch.cat([self.values] + [t.values for t in tarXs], dim=-1)
        return dataclasses.replace(self, values=values)

    def _reduce_to_dense(self, dims: Union[int, Sequence[int]],
                         reduce: str) -> torch.Tensor:
        """Reduce over sparse ``dims`` onto the one sparse dim left, which
        becomes dense; padded rows (``PAD_INDEX``) are dropped.  The ids
        of a kept dim other than 0 are not sorted (``dims=[0]``, the
        cross-subgraph pooling), which ``segment_reduce`` allows."""
        dims = [dims] if isinstance(dims, int) else list(dims)
        keep = [i for i in range(self.sparse_dim) if i not in dims]
        if len(keep) != 1:
            raise NotImplementedError(
                "only a reduction to one sparse dim is ported")
        d = keep[0]
        return segment_reduce(self.values, self.indices[d],
                              self.sparse_shape[d], reduce)

    def sum(self, dims) -> torch.Tensor:
        return self._reduce_to_dense(dims, "sum")

    def mean(self, dims) -> torch.Tensor:
        return self._reduce_to_dense(dims, "mean")

    def diag_to_dense(self) -> torch.Tensor:
        """The full diagonal as a dense ``[sparse_shape[0], *dense]``
        tensor (reference SpTensor.py:322-352): row ``i`` holds the value
        at ``(i, i, ..., i)``, or 0.  The JAX package sends the
        off-diagonal rows to one out-of-range id that its segment sum
        drops; here they are zeroed and summed under their own
        ``indices[0]`` instead (sorted ids, about as many rows an id as
        the subgraph pooling), because in the parity mode PyTorch's
        deterministic ``index_add_`` adds the rows of one id one after
        another, and nearly every tuple would share the dropped id.  The
        ``PAD_INDEX`` padding rows are dropped."""
        first = self.indices[0]
        ondiag = torch.ones_like(first, dtype=torch.bool)
        for d in range(1, self.sparse_dim):
            ondiag &= self.indices[d] == first
        values = torch.where(_expand_mask(ondiag, self.values.dim()),
                             self.values, 0.0)
        return segment_reduce(values, first, self.sparse_shape[0], "sum")

    def diag(self, dims: Optional[Sequence[int]] = None,
             return_sparse: bool = False) -> torch.Tensor:
        """Diagonal extraction over every sparse dim, dense output
        (reference SpTensor.py:322-366).  A partial diagonal and the
        sparse output (which needs the host's ``diag_ind`` pattern) are
        not ported."""
        if return_sparse:
            raise NotImplementedError(
                "SparseTensor.diag(return_sparse=True) is not ported yet")
        if dims is not None and sorted(set(dims)) != list(
                range(self.sparse_dim)):
            raise NotImplementedError(
                "a partial diagonal to dense is not ported")
        return self.diag_to_dense()

    def unpooling_fromdense1dim(self, dims: int,
                                X: torch.Tensor) -> "SparseTensor":
        """Broadcast a dense per-index tensor onto this pattern (reference
        SpTensor.py:470-476): ``out.values[r] = X[indices[dims, r]]``.  The
        index is clamped into ``X``'s rows, as JAX clamps a gather, and the
        padding rows are re-zeroed.  The padding rows gather rows spread
        over ``X`` rather than all the last one (JAX's clamp): their values
        are re-zeroed either way, but the gather's backward is PyTorch's
        sorted ``index_put_``, which adds the rows of one index one after
        another."""
        if not 0 <= dims < self.sparse_dim:
            raise ValueError(f"dims {dims} is not a sparse dim of a "
                             f"{self.sparse_dim}-D tensor")
        rows = X.shape[0]
        spread = torch.arange(self.nnz_pad, device=X.device) % rows
        idx = torch.where(self.rowmask,
                          torch.clamp(self.indices[dims], max=rows - 1),
                          spread)
        return self.tuplewiseapply(lambda _: X[idx])
