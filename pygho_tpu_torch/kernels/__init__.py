"""Hand-written Hopper kernels of the port, one module each.

Each module holds the wrappers that launch its kernels and their plain
PyTorch versions.  ``KERNELS`` lists every kernel role of the port, in
the order the main paths reach them: each entry carries ``NAME``,
``SOURCE`` (the CUDA file), ``REPLACES`` (the TPU kernel role it takes
the place of) and a ``launches`` counter.
"""

from . import channelwise_bmm, segment_attention, spspmm_sum

KERNELS = spspmm_sum.ROLES + channelwise_bmm.ROLES + segment_attention.ROLES

__all__ = ["KERNELS", "channelwise_bmm", "segment_attention", "spspmm_sum"]
