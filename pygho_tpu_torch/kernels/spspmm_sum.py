"""K1 forward: ``out[a] = sum over (a, c, d) of U[c] * V[d]``.

The wrapper :func:`spspmm_sum` launches the hand-written CUDA kernel
``csrc/spspmm_sum.cu`` for tensors on a CUDA device and runs the plain
PyTorch version :func:`spspmm_sum_plain` for tensors on the CPU.  There is
no fallback: on a CUDA tensor it launches the kernel or raises.

It replaces the forward role of the TPU kernel
``pygho_tpu/kernels/strip_spspmm.py:_strip_kernel``.  The triples come
from the host already sorted by output row, with the padding stripped and
a row pointer built (``hodata.loader.add_rowptr``), so each output row is
one segment and the kernel needs no atomics.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "spspmm_sum_fwd_f32"
SOURCE = "pygho_tpu_torch/csrc/spspmm_sum.cu"
REPLACES = "pygho_tpu/kernels/strip_spspmm.py:770 (_strip_kernel, forward)"

# kernel launches since the last reset; only the launch below adds to it
launches = 0


def spspmm_sum_plain(U: torch.Tensor, V: torch.Tensor, acd: torch.Tensor,
                     out_rows: int) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply, sum into rows."""
    a, c, d = acd.long()
    out = torch.zeros(out_rows, U.shape[1], dtype=torch.float32,
                      device=U.device)
    return out.index_add_(0, a, U[c] * V[d])


def _lib() -> ctypes.CDLL:
    lib = _build.load("spspmm_sum")
    fn = lib.spspmm_sum_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                               ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(U, V, acd, rowptr):
    for name, t in (("U", U), ("V", V), ("acd", acd), ("rowptr", rowptr)):
        if t.device != U.device:
            raise ValueError(f"{name} is on {t.device}, U on {U.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if U.dtype != torch.float32 or V.dtype != torch.float32:
        raise TypeError(f"U and V must be float32, got {U.dtype}, {V.dtype}")
    if U.dim() != 2 or V.dim() != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(f"U and V must be (rows, D) with one D, got "
                         f"{tuple(U.shape)} and {tuple(V.shape)}")
    if U.shape[1] == 0:
        raise ValueError("D must be at least 1")
    if acd.dtype != torch.int32 or acd.dim() != 2 or acd.shape[0] != 3:
        raise ValueError(f"acd must be int32 (3, k), got {acd.dtype} "
                         f"{tuple(acd.shape)}")
    if rowptr.dtype != torch.int32 or rowptr.dim() != 1 \
            or rowptr.shape[0] < 1:
        raise ValueError(f"rowptr must be int32 (out_rows + 1,), got "
                         f"{rowptr.dtype} {tuple(rowptr.shape)}")
    if acd.shape[1] >= 2 ** 31:
        raise ValueError("more triples than int32 indices can address")


def spspmm_sum(U: torch.Tensor, V: torch.Tensor, acd: torch.Tensor,
               rowptr: torch.Tensor) -> torch.Tensor:
    """``out[a] = sum over (a, c, d) of U[c] * V[d]`` as an
    ``(out_rows, D)`` float32 tensor, ``out_rows = len(rowptr) - 1``.

    ``acd``: int32 ``(3, k)`` real triples sorted by ``a``; ``rowptr``:
    int32 row pointer of ``acd[0]`` over the output rows.  Every index
    must be in range (checked on the host when the batch is built).
    Rows with no triples come out 0.
    """
    global launches
    _check(U, V, acd, rowptr)
    out_rows = rowptr.shape[0] - 1
    D = U.shape[1]
    if U.device.type == "cpu":
        if int(rowptr[-1]) != acd.shape[1]:
            raise ValueError("rowptr does not cover the triples")
        return spspmm_sum_plain(U, V, acd, out_rows)
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    out = torch.empty(out_rows, D, dtype=torch.float32, device=U.device)
    if out_rows == 0:
        return out
    with torch.cuda.device(U.device):
        fn = _lib().spspmm_sum_fwd_f32
        rc = fn(U.data_ptr(), V.data_ptr(), acd[1].data_ptr(),
                acd[2].data_ptr(), rowptr.data_ptr(), out.data_ptr(),
                out_rows, D, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: CUDA error {rc}")
    launches += 1
    return out
