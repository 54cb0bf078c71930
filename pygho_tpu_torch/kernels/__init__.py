"""Hand-written Hopper kernels of the port, one module each.

Each module holds the wrappers that launch its kernels and their plain
PyTorch versions.  ``KERNELS`` lists every kernel of the port, in the
order the main path reaches them: each entry carries ``NAME``, ``SOURCE``
(the CUDA file), ``REPLACES`` (the TPU kernel role it takes the place of)
and a ``launches`` counter.
"""

from . import spspmm_sum

KERNELS = spspmm_sum.ROLES

__all__ = ["KERNELS", "spspmm_sum"]
