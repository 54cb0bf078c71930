"""The math mode of the port's kernels (port of ``set_fused_math`` and
``get_fused_math`` from ``pygho_tpu/kernels/fused_spspmm.py``).

``True`` (the default) is exact: f32 products summed in f32, what every
kernel computed before the fast variants existed.  ``False`` is the fast
mode of the JAX package's ``--fused`` runs: K1 and K4 round each gathered
operand to bf16, form their products in f32, round each term to bf16 again
and sum the terms in f32 (``kernels/spspmm_sum.py``,
``kernels/segment_attention.py``).

The flag is module state, read by the operators each time they run, as
the JAX package reads it each time it traces: set it before building the
steps or serving, and restore it where a caller changes it for a while.
"""

from __future__ import annotations

_EXACT = True


def set_fused_math(exact: bool) -> None:
    """``exact=False`` selects the fast variants of K1 and K4."""
    global _EXACT
    _EXACT = bool(exact)


def get_fused_math() -> bool:
    """The exact flag: ``True`` for exact f32 math, ``False`` for fast."""
    return _EXACT
