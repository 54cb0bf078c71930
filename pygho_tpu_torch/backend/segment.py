"""Sorted segment reduction (port of ``pygho_tpu/backend/segment.py``,
sum and mean).

Semantics kept from the JAX package:

- segments that receive no contribution yield 0;
- segment ids outside ``[0, num_segments)`` (the ``PAD_INDEX`` padding
  convention) are dropped.

This is plain PyTorch, as the JAX package's segment sums are XLA and not
Pallas.  On the CPU ``index_add_`` sums in index order.  On CUDA it uses
atomics, unless deterministic algorithms are on: the parity mode
(``models.serve.set_parity_numerics``), which the predictor and the
training steps set, turns them on, and ``index_add_`` then sums in a
fixed order, so results are the same from run to run, as the JAX
package's are.  The hot contraction of the main path does not go
through here: it has its own kernels, deterministic in every role
(``kernels/spspmm_sum.py``).
"""

from __future__ import annotations

import torch


def segment_reduce(src: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, aggr: str = "sum") -> torch.Tensor:
    """Reduce rows of ``src`` (``[n, *dense]``) into ``num_segments``
    buckets by ``seg_ids`` (``[n]``).  Returns ``[num_segments, *dense]``.
    """
    if aggr not in ("sum", "mean"):
        raise ValueError(f"unknown or unported aggr {aggr!r}; "
                         f"expected sum|mean")
    # out-of-range ids go to one spare row that is cut off afterwards: a
    # boolean-mask select would wait for the device to count the rows
    seg_ids = seg_ids.long()
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    ids = torch.where(keep, seg_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    out.index_add_(0, ids, src)
    out = out[:num_segments]
    if aggr == "mean":
        cnt = torch.zeros(num_segments + 1, dtype=src.dtype,
                          device=src.device)
        cnt.index_add_(0, ids, torch.ones_like(ids, dtype=src.dtype))
        cnt = cnt[:num_segments].clamp_min(1)
        out = out / cnt.reshape((-1,) + (1,) * (src.dim() - 1))
    return out
