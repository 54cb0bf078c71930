"""pygho_tpu_torch: the PyTorch / CUDA port of pygho_tpu for one NVIDIA
H100.

It imports torch, numpy and scipy, and nothing of JAX or of
``pygho_tpu``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.  The hot contraction of sparse message passing
(K1), the channel-wise product of the dense mode (K5) and their gradients
run as hand-written CUDA kernels (``kernels/``, sources in ``csrc/``),
built with ``nvcc`` at their first use.

Importing the package sets ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8``
where the environment leaves it unset: the parity mode
(``models.serve.set_parity_numerics``) runs cuBLAS under deterministic
algorithms, which PyTorch allows only with that setting in place before
the first cuBLAS call.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from .backend.matensor import MaskedTensor
from .backend.sptensor import SparseTensor
from .device import resolve_device
from .models import MaPredictor, SpPredictor, make_ma_model, make_sp_model

__all__ = ["MaPredictor", "MaskedTensor", "SparseTensor", "SpPredictor",
           "make_ma_model", "make_sp_model", "resolve_device"]
