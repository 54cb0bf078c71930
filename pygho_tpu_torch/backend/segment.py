"""Sorted segment reduction and the segment softmax (port of
``pygho_tpu/backend/segment.py``).

Semantics kept from the JAX package:

- segments that receive no contribution yield 0, for every ``aggr``; so
  does a maximum of ``-inf`` and a minimum of ``+inf`` (a segment whose
  entries in a channel are all ``-inf`` or all ``+inf``), and the segment
  softmax shifts such a segment by 0;
- segment ids outside ``[0, num_segments)`` (the ``PAD_INDEX`` padding
  convention) are dropped.

This is plain PyTorch, as the JAX package's segment reductions are XLA and
not Pallas.  On the CPU ``index_add_`` sums in index order.  On CUDA it
uses atomics, unless deterministic algorithms are on: the parity mode
(``models.serve.set_parity_numerics``), which the predictor and the
training steps set, turns them on, and ``index_add_`` then sums in a
fixed order, so results are the same from run to run, as the JAX
package's are.  A maximum or minimum does not depend on the order.  The
hot loops of the main paths do not go through here: they have their own
kernels, deterministic in every role (``kernels/spspmm_sum.py``,
``kernels/segment_attention.py``), whose plain versions are built on
these functions.
"""

from __future__ import annotations

import torch

_AGGRS = ("sum", "mean", "max", "min")


def segment_reduce(src: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, aggr: str = "sum") -> torch.Tensor:
    """Reduce rows of ``src`` (``[n, *dense]``) into ``num_segments``
    buckets by ``seg_ids`` (``[n]``).  Returns ``[num_segments, *dense]``.
    ``aggr``: ``"sum"``, ``"mean"``, ``"max"`` or ``"min"``.
    """
    if aggr not in _AGGRS:
        raise ValueError(f"unknown aggr {aggr!r}; expected "
                         f"{'|'.join(_AGGRS)}")
    # out-of-range ids go to one spare row that is cut off afterwards: a
    # boolean-mask select would wait for the device to count the rows
    seg_ids = seg_ids.long()
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(keep, seg_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if aggr in ("max", "min"):
        # include_self=False: a segment with no contribution keeps its 0
        idx = ids.reshape((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
        out = out.scatter_reduce(0, idx, src, "a" + aggr,
                                 include_self=False)[:num_segments]
        inf = out.isneginf() if aggr == "max" else out.isposinf()
        return torch.where(inf, 0.0, out)
    out.index_add_(0, ids, src)
    out = out[:num_segments]
    if aggr == "mean":
        cnt = torch.zeros(num_segments + 1, dtype=src.dtype,
                          device=src.device)
        cnt.index_add_(0, ids, torch.ones_like(ids, dtype=src.dtype))
        cnt = cnt[:num_segments].clamp_min(1)
        out = out / cnt.reshape((-1,) + (1,) * (src.dim() - 1))
    return out


def segment_softmax(src: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int,
                    stable: str = "segment") -> torch.Tensor:
    """Softmax of the rows of ``src`` within each segment, per channel.

    ``stable`` picks the shift that keeps ``exp`` in range, which cancels
    in the ratio: ``"segment"`` subtracts each segment's maximum (safe for
    any range); ``"global"`` subtracts each channel's maximum over all
    rows, not differentiated (entries more than about 87 below it
    underflow to 0).  As in the JAX package, the denominator is held at
    1e-16 or more, and a row whose id is out of range reads the last
    segment's shift and denominator (JAX clamps gather indices)."""
    if stable == "global":
        m = src.detach().amax(dim=0, keepdim=True)
        e = torch.exp(src - torch.where(torch.isfinite(m), m, 0.0))
    elif stable == "segment":
        # segment_reduce's maximum is already 0 where it would be -inf
        m = segment_reduce(src, seg_ids, num_segments, "max")
        e = torch.exp(src - m[_clamped(seg_ids, num_segments)])
    else:
        raise ValueError(f"unknown stable {stable!r}; expected "
                         f"segment|global")
    den = segment_reduce(e, seg_ids, num_segments, "sum").clamp_min(1e-16)
    return e / den[_clamped(seg_ids, num_segments)]


def _clamped(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return seg_ids.long().clamp(0, max(num_segments - 1, 0))
