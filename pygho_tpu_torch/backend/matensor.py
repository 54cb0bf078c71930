"""MaskedTensor: a padded dense tensor and its boolean validity mask (port
of ``pygho_tpu/backend/matensor.py``).

``mask`` is True for valid entries and covers the leading (masked) dims of
``data``; the trailing dims are dense features.  Reductions fill the
invalid entries with the value neutral to the reduction, reduce densely
and keep a validity mask of the result, as the JAX package does:

- ``mean`` divides by the count of valid entries, clamped at 1, so an
  all-masked row gives 0 and not NaN;
- ``max`` and ``min`` fill with -inf and +inf, then map an inf left in
  the result (an all-masked row) to 0.  ``min`` computes a minimum: the
  JAX package's fix of the reference's ``min``, which returned a max.
  They use ``torch.amax``/``torch.amin``, whose gradient splits evenly
  among ties, as JAX's does (``torch.max(dim)`` sends it all to one).

``diag``, ``unpooling``, ``diagonalapply`` and ``catvalue`` are not on a
ported path yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple, Union

import torch

Dims = Union[int, Sequence[int]]


def filterinf(x: torch.Tensor, filled_value: float = 0.0) -> torch.Tensor:
    """Replace +/-inf with ``filled_value`` (reference MaTensor.py:8-31)."""
    return torch.where(torch.isinf(x),
                       torch.full((), filled_value, dtype=x.dtype,
                                  device=x.device), x)


def _canon(dims: Dims) -> Tuple[int, ...]:
    return (dims,) if isinstance(dims, int) else tuple(dims)


@dataclasses.dataclass(frozen=True)
class MaskedTensor:
    data: torch.Tensor   # [*maskedshape, *denseshape]
    mask: torch.Tensor   # bool[*maskedshape], True = valid

    def __post_init__(self):
        if self.data.dim() < self.mask.dim() \
                or tuple(self.data.shape[:self.mask.dim()]) \
                != tuple(self.mask.shape):
            raise ValueError(f"mask {tuple(self.mask.shape)} does not lead "
                             f"data {tuple(self.data.shape)}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def masked_dim(self) -> int:
        return self.mask.dim()

    @property
    def dense_dim(self) -> int:
        return self.data.dim() - self.mask.dim()

    @property
    def maskedshape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[:self.mask.dim()])

    @property
    def denseshape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[self.mask.dim():])

    @property
    def fullmask(self) -> torch.Tensor:
        """``mask`` reshaped to broadcast against ``data``."""
        return self.mask.reshape(tuple(self.mask.shape)
                                 + (1,) * self.dense_dim)

    def fill_masked(self, val: float = 0.0) -> torch.Tensor:
        """``data`` with the invalid entries set to ``val`` (reference
        MaTensor.py:122-128); a new tensor, ``data`` is left as it is."""
        return torch.where(self.fullmask, self.data,
                           torch.full((), val, dtype=self.data.dtype,
                                      device=self.data.device))

    def _outmask(self, dims, keepdim: bool) -> torch.Tensor:
        return torch.any(self.mask, dim=dims, keepdim=keepdim)

    def sum(self, dims: Dims, keepdim: bool = False) -> "MaskedTensor":
        dims = _canon(dims)
        return MaskedTensor(
            torch.sum(self.fill_masked(0.0), dim=dims, keepdim=keepdim),
            self._outmask(dims, keepdim))

    def mean(self, dims: Dims, keepdim: bool = False) -> "MaskedTensor":
        dims = _canon(dims)
        cnt = torch.sum(self.fullmask, dim=dims, keepdim=keepdim) \
            .clamp_min(1)
        s = self.sum(dims, keepdim)
        return MaskedTensor(s.data / cnt.to(s.data.dtype), s.mask)

    def max(self, dims: Dims, keepdim: bool = False) -> "MaskedTensor":
        dims = _canon(dims)
        out = torch.amax(self.fill_masked(-torch.inf), dim=dims,
                         keepdim=keepdim)
        return MaskedTensor(filterinf(out, 0.0), self._outmask(dims, keepdim))

    def min(self, dims: Dims, keepdim: bool = False) -> "MaskedTensor":
        dims = _canon(dims)
        out = torch.amin(self.fill_masked(torch.inf), dim=dims,
                         keepdim=keepdim)
        return MaskedTensor(filterinf(out, 0.0), self._outmask(dims, keepdim))

    def tuplewiseapply(self, func: Callable[[torch.Tensor], torch.Tensor]
                       ) -> "MaskedTensor":
        """``func`` over the zero-filled data; the mask is kept.  Invalid
        entries of the result hold whatever ``func`` made of 0: every
        consumer fills them again."""
        return MaskedTensor(func(self.fill_masked(0.0)), self.mask)

    def add(self, tarX: "MaskedTensor", samesparse: bool) -> "MaskedTensor":
        if samesparse:
            return MaskedTensor(self.data + tarX.data, self.mask)
        return MaskedTensor(self.fill_masked(0.0) + tarX.fill_masked(0.0),
                            torch.logical_or(self.mask, tarX.mask))

    def diag(self, dims: Sequence[int]) -> "MaskedTensor":
        raise NotImplementedError("MaskedTensor.diag is not ported yet")

    def unpooling(self, dims: Dims, tarX: "MaskedTensor") -> "MaskedTensor":
        raise NotImplementedError("MaskedTensor.unpooling is not ported yet")

    def diagonalapply(self, func) -> "MaskedTensor":
        raise NotImplementedError(
            "MaskedTensor.diagonalapply is not ported yet")

    def catvalue(self, tarXs, samesparse: bool) -> "MaskedTensor":
        raise NotImplementedError("MaskedTensor.catvalue is not ported yet")
