"""Structured metrics: a jsonl event log and the reference's per-epoch
print format (port of ``pygho_tpu/utils/metrics.py``; reference
example/zinc.py:425-427).

The records and the echoed line are the JAX package's, field for field,
so the two packages' runs read alike.  ``CompileCounter`` is not ported:
it counts XLA backend compiles, and eager PyTorch compiles nothing per
shape (``ROADMAP.md``, Queue A item 11).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only jsonl metrics with the reference's stdout line format.

    Each ``log`` writes one record with ``t``, the seconds since the
    logger was made; each ``log_epoch`` writes an ``"epoch"`` record and,
    with ``echo``, prints the line the reference prints (trn time / val
    time / memory / l1loss / val MAE / tst MAE).  Without a ``path``
    nothing is written.
    """

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
        self.t0 = time.time()

    def log(self, record: Dict[str, Any]):
        record = {"t": round(time.time() - self.t0, 3), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def log_epoch(self, epoch: int, trn_time: float, val_time: float,
                  mem_gb: float, trn_loss: float, val_mae: float,
                  tst_mae: float, lr: Optional[float] = None):
        self.log({"type": "epoch", "epoch": epoch, "trn_time": trn_time,
                  "val_time": val_time, "mem_gb": mem_gb,
                  "trn_loss": trn_loss, "val_mae": val_mae,
                  "tst_mae": tst_mae, "lr": lr})
        if self.echo:
            print(f"epoch {epoch} trn time {trn_time:.2f} "
                  f"val time {val_time:.2f} memory {mem_gb:.2f} GB  "
                  f"l1loss {trn_loss:.4f} val MAE {val_mae:.4f} "
                  f"tst MAE {tst_mae:.4f}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
