"""Device memory statistics (the memory half of
``pygho_tpu/utils/profiling.py``).

``profile_trace`` is not ported yet (``ROADMAP.md``, Queue A item 11);
``scripts/trace_train_gpu.py`` traces training steps with
``torch.profiler`` meanwhile.
"""

from __future__ import annotations

from typing import Dict

import torch

# torch.cuda.memory_stats keys under the JAX package's names (bytes -> gb)
_KEYS = (("allocated_bytes.all.current", "gb_in_use"),
         ("allocated_bytes.all.peak", "peak_gb_in_use"))


def device_memory_stats(device=None) -> Dict[str, float]:
    """Memory statistics of a CUDA device in GB, under the JAX package's
    keys: ``gb_in_use`` and ``peak_gb_in_use`` (the caching allocator's
    allocated bytes now and at their peak since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``gb_limit`` (the
    device's total memory).  JAX's ``largest_alloc_size`` is left out:
    the caching allocator's statistics have no such entry.  ``{}`` for the
    CPU or with no card, as JAX returns for a backend that reports
    nothing.

    ``device``: a CUDA device (default: the current one)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return {}
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    g = 1024 ** 3
    out = {name: stats[k] / g for k, name in _KEYS if k in stats}
    out["gb_limit"] = torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device()
    ).total_memory / g
    return out
