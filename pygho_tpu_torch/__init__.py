"""pygho_tpu_torch: the PyTorch / CUDA port of pygho_tpu for one NVIDIA
H100.

It imports torch, numpy and scipy, and nothing of JAX or of
``pygho_tpu``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.  The hot contraction of sparse message passing
runs as a hand-written CUDA kernel (``kernels/``, sources in ``csrc/``),
built with ``nvcc`` at its first use.
"""

from .backend.sptensor import SparseTensor
from .device import resolve_device
from .models import SpPredictor, make_sp_model

__all__ = ["SparseTensor", "SpPredictor", "make_sp_model", "resolve_device"]
