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
The SD mode's batched adjacency is a 3-sparse-dim tensor ``(b, n, n)``
(``hodata.collate_dense(denseadj=False)``): its encoder runs through
:meth:`tuplewiseapply`, and ``backend.spmamm`` reads :attr:`rowmask`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

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

    def add(self, tarX: "SparseTensor", samesparse: bool) -> "SparseTensor":
        """Add two SparseTensors of one pattern (reference
        SpTensor.py:507-514).  Only ``samesparse=True`` is ported."""
        if not samesparse:
            raise NotImplementedError(
                "SparseTensor.add(samesparse=False) is not ported yet")
        return dataclasses.replace(self, values=self.values + tarX.values)

    def _reduce_to_dense(self, dims: Union[int, Sequence[int]],
                         reduce: str) -> torch.Tensor:
        """Reduce over sparse ``dims`` onto the one sparse dim left, which
        becomes dense; padded rows (``PAD_INDEX``) are dropped."""
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
