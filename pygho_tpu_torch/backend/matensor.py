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

``diag`` and ``unpooling`` are views, as JAX's ``jnp.diagonal`` and
``broadcast_to`` are: the joint diagonal of two or more masked dims, and
a broadcast along new masked dims to a target's shape (an ``expand``, so
no ``(b, n, n, d)`` copy is made or kept for autograd).
``diagonalapply`` hands a function the data and an int mask of the
diagonal of ``(b, n, n)`` tuples (SUN's ``HeteroLinear``), ``catvalue``
concatenates the zero-filled values of tensors of one mask.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence, Tuple, Union

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
        """The joint diagonal of the masked ``dims``, placed at ``dims[0]``
        (reference MaTensor.py:208-223): a view."""
        dims = sorted(dims)
        if len(dims) < 2:
            raise ValueError("diag takes two or more dims")
        tdata = torch.diagonal(self.data, 0, dims[0], dims[1])
        tmask = torch.diagonal(self.mask, 0, dims[0], dims[1])
        for d in dims[2:]:
            tdata = torch.diagonal(tdata, 0, d, -1)
            tmask = torch.diagonal(tmask, 0, d, -1)
        return MaskedTensor(tdata.movedim(-1, dims[0]),
                            tmask.movedim(-1, dims[0]))

    def unpooling(self, dims: Dims, tarX: "MaskedTensor") -> "MaskedTensor":
        """Broadcast along the new masked ``dims`` to ``tarX``'s shape,
        carrying ``tarX.mask`` (reference MaTensor.py:225-234): an
        ``expand`` of a view, which copies nothing."""
        dims = sorted(_canon(dims))
        tdata = self.data
        for d in dims:
            tdata = tdata.unsqueeze(d)
        target = tuple(tarX.shape[i] if i in dims else tdata.shape[i]
                       for i in range(tdata.dim()))
        return MaskedTensor(tdata.expand(target), tarX.mask)

    def diagonalapply(self, func: Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor]
                      ) -> "MaskedTensor":
        """``func(data, eye)``, ``eye`` the int32 mask of the diagonal
        broadcast to the masked shape, for ``(b, n, n)`` tuples only
        (reference MaTensor.py:241-249); the mask is kept."""
        if self.masked_dim != 3:
            raise ValueError("diagonalapply takes (b, n, n) tuples")
        eye = torch.eye(self.shape[1], self.shape[2], dtype=torch.int32,
                        device=self.data.device)
        return MaskedTensor(func(self.data, eye.expand(self.maskedshape)),
                            self.mask)

    def catvalue(self, tarXs: Union["MaskedTensor",
                                    Iterable["MaskedTensor"]],
                 samesparse: bool) -> "MaskedTensor":
        """The zero-filled values of ``self`` and ``tarXs`` concatenated
        along the last dim, with ``self``'s mask; ``samesparse`` only, as
        in the JAX package."""
        if not samesparse:
            raise NotImplementedError(
                "catvalue takes tensors of one mask (samesparse=True), as "
                "the JAX package's does")
        if isinstance(tarXs, MaskedTensor):
            tarXs = [tarXs]
        return MaskedTensor(
            torch.cat([self.fill_masked(0.0)]
                      + [t.fill_masked(0.0) for t in tarXs], dim=-1),
            self.mask)
