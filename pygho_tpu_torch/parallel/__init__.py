"""Parallel training paths (port of ``pygho_tpu/parallel``).

Ported so far: the giant-graph path of ``giant.py`` on one card (P = 1),
its contraction on K3, the short-row gather.  The data-, tensor- and
pipeline-parallel paths, the mesh and the multi-card tuple-parallel
strategies are not ported yet (``ROADMAP.md``, S7).
"""

from .giant import (GiantGraphPlan, GiantNGNN, build_giant_graph_plan,
                    init_giant_params, make_giant_graph_step)

__all__ = ["GiantGraphPlan", "GiantNGNN", "build_giant_graph_plan",
           "init_giant_params", "make_giant_graph_step"]
