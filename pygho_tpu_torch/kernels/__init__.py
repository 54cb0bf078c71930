"""Hand-written Hopper kernels of the port, one module each.

Each module holds the wrapper that launches its kernel, the kernel's plain
PyTorch version, a ``launches`` counter and the metadata ``NAME``,
``SOURCE`` (the CUDA file) and ``REPLACES`` (the TPU kernel it takes the
place of).  ``KERNELS`` lists them in the order the main path reaches
them.
"""

from . import spspmm_sum

KERNELS = (spspmm_sum,)

__all__ = ["KERNELS", "spspmm_sum"]
