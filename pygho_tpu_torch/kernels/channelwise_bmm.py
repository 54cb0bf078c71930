"""K5: the channel-wise batched matrix product of the dense mode,

    out[b, i, j, d] = sum over k of A[b, i, k, d] * X[b, k, j, d],

its gradients, and the ``torch.autograd.Function`` that ties them
together.  The three roles are the same product on other operands
(ᵀ swaps the two n axes):

- forward, ``FWD``: ``cw(A, X)``;
- ``DA``: ``dA = cw(g, Xᵀ)``;
- ``DX``: ``dX = cw(Aᵀ, g)``.

The raw wrapper :func:`cw_bmm` launches a role's hand-written CUDA kernel
(``csrc/channelwise_bmm.cu``) for tensors on a CUDA device, reading each
operand through its strides, so a transposed operand is a view and is not
copied; for tensors on the CPU it runs the plain PyTorch version
:func:`cw_bmm_plain`.  There is no fallback: on a CUDA tensor it launches
the kernel or raises.  The raw wrapper builds no autograd graph, so it
refuses a tensor that requires grad while grad mode is on;
:class:`ChannelwiseBmm` is the differentiable entry point, on both
devices, and runs the same three roles.

Each role has a bf16 variant beside its f32 one, chosen by the stored
dtypes of the operands, as ``_cw_kernel`` widens whatever it is given to
f32 (``a_ref[0].astype(f32)``): the forward on bf16 ``A`` and ``X``
(``cw_bmm_fwd_bf16``), dA on an f32 cotangent and a bf16 ``Xᵀ``
(``cw_bmm_da_bf16``), dX on a bf16 ``Aᵀ`` and an f32 cotangent
(``cw_bmm_dx_bf16``).  A variant widens its bf16 operands on the card
(exactly), so it computes what the f32 role computes on the widened
operands, and writes f32.  ``ChannelwiseBmm`` returns each gradient in its
operand's dtype, as ``_cw_bwd`` does.

They replace the TPU kernel
``pygho_tpu/kernels/channelwise_bmm.py:_cw_kernel``, which
``channelwise_bmm`` runs for the forward and, through ``_cw_bwd``, for
both gradients, on f32 or bf16 inputs.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import _build
from .spspmm_sum import Role, add_variants, operands_dtype

SOURCE = "pygho_tpu_torch/csrc/channelwise_bmm.cu"

FWD = Role("cw_bmm_fwd_f32",
           "pygho_tpu/kernels/channelwise_bmm.py:51 (_cw_kernel, forward, "
           "launched by _cw_bmm_raw :64)", SOURCE)
DA = Role("cw_bmm_da_f32",
          "pygho_tpu/kernels/channelwise_bmm.py:51 (_cw_kernel, dA = "
          "cw(g, X^T) in _cw_bwd :136)", SOURCE)
DX = Role("cw_bmm_dx_f32",
          "pygho_tpu/kernels/channelwise_bmm.py:51 (_cw_kernel, dX = "
          "cw(A^T, g) in _cw_bwd :138)", SOURCE)
ROLES = (FWD, DA, DX)
# the bf16 variant of each role, in the order of ROLES
BF16_ROLES = add_variants(ROLES, (("bf16", torch.bfloat16, True),))
for _role, _what in zip(BF16_ROLES, ("forward on bf16 A and X",
                                     "dA on f32 g and bf16 X^T",
                                     "dX on bf16 A^T and f32 g")):
    _role.REPLACES = (f"pygho_tpu/kernels/channelwise_bmm.py:51 (_cw_kernel "
                      f"on bf16 inputs, widened at :53-54; {_what})")

# which operand (0: A, 1: X) is the cotangent g, always f32, in each role
_GRAD_OPERAND = {FWD: None, DA: 0, DX: 1}


def cw_bmm_plain(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of every role and variant: the operands
    widened to f32 (exactly, from bf16), k in ascending order, each
    product rounded before it is added, as ``_cw_kernel`` and the CUDA
    kernel sum."""
    A, X = A.float(), X.float()
    Bsz, n, _, D = A.shape
    acc = torch.zeros(Bsz, n, n, D, dtype=torch.float32, device=A.device)
    for k in range(n):
        acc = acc + A[:, :, k, None, :] * X[:, None, k, :, :]
    return acc


def _lib() -> ctypes.CDLL:
    lib = _build.load("channelwise_bmm")
    for role in ROLES + BF16_ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 4) * 2 \
                + [ctypes.c_void_p] + [ctypes.c_int64] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def stored_dtype(role: Role, A: torch.Tensor, X: torch.Tensor
                 ) -> torch.dtype:
    """The stored dtype that picks ``role``'s variant: both operands' in
    the forward, the operand's beside the f32 cotangent (dA's ``A``, dX's
    ``X``) in the gradient roles (``spspmm_sum.operands_dtype``)."""
    return operands_dtype(role.base.NAME, _GRAD_OPERAND[role.base], A, X,
                          "AX")


def _check(A: torch.Tensor, X: torch.Tensor) -> None:
    if X.device != A.device:
        raise ValueError(f"X is on {X.device}, A on {A.device}")
    if A.dim() != 4 or tuple(A.shape) != tuple(X.shape) \
            or A.shape[1] != A.shape[2]:
        raise ValueError(f"A and X must be (b, n, n, d) of one shape, got "
                         f"{tuple(A.shape)} and {tuple(X.shape)}")
    if torch.is_grad_enabled() and (A.requires_grad or X.requires_grad):
        raise RuntimeError(
            "the raw K5 wrapper builds no autograd graph, and its input "
            "requires grad: call ChannelwiseBmm.apply (backend.mamamm "
            "does), or run under torch.no_grad()")


def cw_bmm(role: Role, A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One role of K5, ``out[b,i,j,d] = sum_k A[b,i,k,d] * X[b,k,j,d]``,
    as a contiguous ``(b, n, n, d)`` float32 tensor, in the variant of
    ``role`` that the operands' dtypes select (:func:`stored_dtype`).
    ``A`` and ``X`` may be any strided views (a transposed operand is read
    in place)."""
    _check(A, X)
    role = role.variant(stored_dtype(role, A, X), True)
    if A.device.type == "cpu":
        return cw_bmm_plain(A, X)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    out = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    Bsz, n, _, D = A.shape
    with torch.cuda.device(A.device):
        fn = getattr(_lib(), role.NAME)
        rc = fn(A.data_ptr(), *A.stride(), X.data_ptr(), *X.stride(),
                out.data_ptr(), Bsz, n, D,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1
    return out


class ChannelwiseBmm(torch.autograd.Function):
    """Differentiable K5: ``ChannelwiseBmm.apply(A, X)``.

    Forward: the forward role, an f32 result.  Backward (``_cw_bwd``): the
    dA role gives ``grad_A = cw(g, Xᵀ)`` and the dX role ``grad_X =
    cw(Aᵀ, g)``, each run only where ``ctx.needs_input_grad`` asks for it
    and returned in its operand's dtype.  The incoming gradient is taken
    in f32; the transposes are strided views.  f32 or bf16 operands, both
    of one dtype (the variant follows it)."""

    @staticmethod
    def forward(ctx, A, X):
        ctx.save_for_backward(A, X)
        return cw_bmm(FWD, A, X)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        A, X = ctx.saved_tensors
        g = g.to(torch.float32)
        dA = cw_bmm(DA, g, X.transpose(1, 2)).to(A.dtype) \
            if ctx.needs_input_grad[0] else None
        dX = cw_bmm(DX, A.transpose(1, 2), g).to(X.dtype) \
            if ctx.needs_input_grad[1] else None
        return dA, dX
