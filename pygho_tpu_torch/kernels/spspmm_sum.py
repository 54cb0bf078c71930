"""K1: ``out[a] = sum over (a, c, d) of U[c] * V[d]``, its gradients, and
the ``torch.autograd.Function`` that ties them together.

The contraction has three roles, each a segment sum over triples
``(t, u, v)`` sorted by the output row ``t``,
``out[t] += L[u] * R[v]``:

- forward, ``FWD``: ``out[a] += U[c] * V[d]`` over ``(a, c, d)``;
- ``DX``: ``dU[c] += g[a] * V[d]`` over ``(c, a, d)``;
- ``DA``: ``dV[d] += U[c] * g[a]`` over ``(d, c, a)``.

The host gives each role its triples already in that order, with the
padding stripped and a row pointer built (``hodata.loader.add_rowptr``),
so each output row is one segment and no role needs atomics.  The
kernel gives each warp a chunk of ``role.CHUNK`` triples and the output
rows that start in it (``csrc/chunk_walk.cuh``); the chunks come from the
triples' own output rows ``tuv[0]``, so nothing more is built on the
host.

The raw wrapper :func:`contract` launches a role's hand-written CUDA kernel
(``csrc/spspmm_sum.cu``) for tensors on a CUDA device and runs the plain
PyTorch version :func:`contract_plain` for tensors on the CPU.  There is
no fallback: on a CUDA tensor it launches the kernel or raises.  The raw
wrapper builds no autograd graph, so it refuses a tensor that requires
grad while grad mode is on; :class:`SpspmmSum` is the differentiable
entry point, on both devices, and runs the same three roles.

They replace the three roles of the TPU kernel
``pygho_tpu/kernels/strip_spspmm.py:_strip_kernel`` behind
``fused_spspmm_strip``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

SOURCE = "pygho_tpu_torch/csrc/spspmm_sum.cu"


class Role:
    """One role of a kernel: the name of its kernel (also its C entry
    point in ``SOURCE``, the CUDA file), the TPU kernel role it replaces,
    for kernels that take chunks of triples the triples of a warp's chunk
    (``CHUNK``, at most 32), and the count of its launches since the last
    reset (only a kernel launch adds to it)."""

    def __init__(self, name: str, replaces: str, source: str = SOURCE,
                 chunk: Optional[int] = None):
        self.NAME = name
        self.REPLACES = replaces
        self.SOURCE = source
        self.CHUNK = chunk
        self.launches = 0

    def __repr__(self):
        return f"Role({self.NAME})"


# each role's chunk, from a sweep of 8, 16 and 32 on the card at the main
# path's shape (scripts/k1_k4_ab_gpu.py)
FWD = Role("spspmm_sum_fwd_f32",
           "pygho_tpu/kernels/strip_spspmm.py:770 (_strip_kernel, forward "
           "role on the forward plan, :1092)", chunk=32)
DX = Role("spspmm_sum_dx_f32",
          "pygho_tpu/kernels/strip_spspmm.py:770 (_strip_kernel, dX role "
          "on the dX plan, :1095; _bwd_rule :1127)", chunk=32)
DA = Role("spspmm_sum_da_f32",
          "pygho_tpu/kernels/strip_spspmm.py:770 (_strip_kernel, dA role "
          "on the dA plan, :1097; _bwd_rule :1130)", chunk=32)
ROLES = (FWD, DX, DA)


def contract_plain(U: torch.Tensor, V: torch.Tensor, tuv: torch.Tensor,
                   out_rows: int) -> torch.Tensor:
    """The plain PyTorch version of every role: gather, multiply, sum
    into rows, ``out[t] += U[u] * V[v]``."""
    t, u, v = tuv.long()
    out = torch.zeros(out_rows, U.shape[1], dtype=torch.float32,
                      device=U.device)
    return out.index_add_(0, t, U[u] * V[v])


def _lib() -> ctypes.CDLL:
    lib = _build.load("spspmm_sum")
    for role in ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(U, V, tuv, rowptr):
    for name, t in (("U", U), ("V", V), ("tuv", tuv), ("rowptr", rowptr)):
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
    if tuv.dtype != torch.int32 or tuv.dim() != 2 or tuv.shape[0] != 3:
        raise ValueError(f"triples must be int32 (3, k), got {tuv.dtype} "
                         f"{tuple(tuv.shape)}")
    if rowptr.dtype != torch.int32 or rowptr.dim() != 1 \
            or rowptr.shape[0] < 1:
        raise ValueError(f"rowptr must be int32 (out_rows + 1,), got "
                         f"{rowptr.dtype} {tuple(rowptr.shape)}")
    if tuv.shape[1] >= 2 ** 31:
        raise ValueError("more triples than int32 indices can address")
    if torch.is_grad_enabled() and (U.requires_grad or V.requires_grad):
        raise RuntimeError(
            "the raw K1 wrapper builds no autograd graph, and its input "
            "requires grad: call SpspmmSum.apply (backend.spspmm does), "
            "or run under torch.no_grad()")


def contract(role: Role, U: torch.Tensor, V: torch.Tensor,
             tuv: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """One role of K1, ``out[t] = sum over (t, u, v) of U[u] * V[v]``, as
    an ``(out_rows, D)`` float32 tensor, ``out_rows = len(rowptr) - 1``.

    ``tuv``: int32 ``(3, k)`` real triples sorted by ``t``; ``rowptr``:
    int32 row pointer of ``tuv[0]`` over the output rows.  Every index
    must be in range (checked on the host when the batch is built).
    Rows with no triples come out 0.
    """
    _check(U, V, tuv, rowptr)
    out_rows = rowptr.shape[0] - 1
    D = U.shape[1]
    if U.device.type == "cpu":
        if int(rowptr[-1]) != tuv.shape[1]:
            raise ValueError("rowptr does not cover the triples")
        return contract_plain(U, V, tuv, out_rows)
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    out = torch.empty(out_rows, D, dtype=torch.float32, device=U.device)
    if out_rows == 0:
        return out
    with torch.cuda.device(U.device):
        fn = getattr(_lib(), role.NAME)
        rc = fn(U.data_ptr(), V.data_ptr(), tuv[0].data_ptr(),
                tuv[1].data_ptr(), tuv[2].data_ptr(), rowptr.data_ptr(),
                out.data_ptr(), tuv.shape[1], role.CHUNK, out_rows, D,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1
    return out


def spspmm_sum(U: torch.Tensor, V: torch.Tensor, acd: torch.Tensor,
               rowptr: torch.Tensor) -> torch.Tensor:
    """The forward role: ``out[a] = sum over (a, c, d) of U[c] * V[d]``."""
    return contract(FWD, U, V, acd, rowptr)


# the backward roles' triples and row pointers: (cad, rowptr_dx, dca,
# rowptr_da), as ``hodata.loader.add_rowptr(..., backward=True)`` builds
BackwardOrders = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]


class SpspmmSum(torch.autograd.Function):
    """Differentiable K1: ``SpspmmSum.apply(U, V, acd, rowptr, bwd)``.

    Forward: the forward role.  Backward: the dX role gives ``grad_U``
    and the dA role gives ``grad_V``, each run only where
    ``ctx.needs_input_grad`` asks for it (the counterpart of
    ``fused_spspmm_strip``'s ``_bwd_rule``).  ``bwd`` is the backward
    orders (:data:`BackwardOrders`); without them the forward runs, and a
    backward through it raises.  The incoming gradient is taken in f32.
    """

    @staticmethod
    def forward(ctx, U, V, acd, rowptr, bwd: Optional[BackwardOrders]):
        if bwd is not None:
            _, rp_dx, _, rp_da = bwd
            if rp_dx.shape[0] != U.shape[0] + 1 \
                    or rp_da.shape[0] != V.shape[0] + 1:
                raise ValueError(
                    f"backward row pointers span {rp_dx.shape[0] - 1} and "
                    f"{rp_da.shape[0] - 1} rows, U and V have "
                    f"{U.shape[0]} and {V.shape[0]}")
        ctx.save_for_backward(U, V)
        ctx.bwd = bwd
        return contract(FWD, U, V, acd, rowptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        U, V = ctx.saved_tensors
        if ctx.bwd is None:
            raise RuntimeError(
                "a gradient flows through spspmm, but the batch has no "
                "backward orders: batch with SpDataloader(..., "
                "backward=True) (add_rowptr(..., backward=True))")
        cad, rp_dx, dca, rp_da = ctx.bwd
        g = g.to(torch.float32).contiguous()
        dU = contract(DX, g, V, cad, rp_dx) \
            if ctx.needs_input_grad[0] else None
        dV = contract(DA, U, g, dca, rp_da) \
            if ctx.needs_input_grad[1] else None
        return dU, dV, None, None, None
