"""Dense tuple sampler (port of ``spdsampler`` from
``pygho_tpu/hodata/ma_sampler.py``).

A sampler returns the flat row-major ``(n * n,)`` tuple features and the
masked shape ``(n, n)``, which ``ma_data.collate_dense`` pads and stacks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .graph import Graph
from .sp_sampler import _spd_matrix


def spdsampler(graph: Graph, hop: int = 2) -> Dict[str, np.ndarray]:
    """All-pairs shortest-path distance clamped to ``hop + 1``; an
    unreachable pair (inf) clamps to ``hop + 1`` too (reference
    MaTupleSampler.py:11-32)."""
    dist = np.minimum(_spd_matrix(graph), hop + 1)
    return {
        "tuplefeat": dist.reshape(-1).astype(np.int64),
        "tupleshape": np.array([graph.num_nodes] * 2, dtype=np.int64),
    }
