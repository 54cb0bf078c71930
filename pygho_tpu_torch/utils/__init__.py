"""Auxiliary subsystems (port of ``pygho_tpu/utils``): structured
metrics, checkpoints and device memory statistics.

Ported so far: ``MetricsLogger``, ``save_checkpoint`` /
``restore_checkpoint`` and ``device_memory_stats``.  ``CompileCounter``
counts XLA compiles and has no counterpart in eager PyTorch;
``profile_trace``, the typed configs and the debugging helpers wait
(``ROADMAP.md``, Queue A item 11).
"""

from .checkpoint import restore_checkpoint, save_checkpoint
from .metrics import MetricsLogger
from .profiling import device_memory_stats

__all__ = ["MetricsLogger", "device_memory_stats", "restore_checkpoint",
           "save_checkpoint"]
