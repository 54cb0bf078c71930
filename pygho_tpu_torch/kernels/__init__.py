"""Hand-written Hopper kernels of the port, one module each.

Each module holds the wrappers that launch its kernels and their plain
PyTorch versions.  ``KERNELS`` lists every kernel role of the port, in
the order the main paths reach them: each entry carries ``NAME``,
``SOURCE`` (the CUDA file), ``REPLACES`` (the TPU kernel role it takes
the place of) and a ``launches`` counter.  K1 and K4 list each role in
its four variants (f32, f32 fast, bf16, bf16 fast), chosen by the
operands' dtype and :func:`get_fused_math`; K3 each role in f32 and f32
fast, chosen by the math mode; K5 each role in f32 and bf16, chosen by
the operands' dtypes.
"""

from . import channelwise_bmm, segment_attention, spspmm_sum, window_spspmm
from .numerics import get_fused_math, set_fused_math

KERNELS = (spspmm_sum.ROLES + channelwise_bmm.ROLES + segment_attention.ROLES
           + window_spspmm.ROLES + spspmm_sum.FAST_ROLES
           + segment_attention.FAST_ROLES + channelwise_bmm.BF16_ROLES
           + window_spspmm.FAST_ROLES)

__all__ = ["KERNELS", "channelwise_bmm", "get_fused_math",
           "segment_attention", "set_fused_math", "spspmm_sum",
           "window_spspmm"]
