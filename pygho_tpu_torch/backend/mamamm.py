"""Masked dense x masked dense contraction (port of
``pygho_tpu/backend/mamamm.py``).

Contracts masked dim ``dim1`` of ``A`` with masked dim ``dim2`` of ``B``
over zero-filled data.  The channel-wise case, two ``(b, n, n, d)``
operands contracted over one n axis each with the batch dim shared, is
the PPGN/2-FWL product and the within-subgraph product of every dense
conv: it goes to the K5 kernel (``kernels/channelwise_bmm.py``) through
its autograd Function, so its gradients run the kernel's dA and dX roles.
The four ``(dim1, dim2)`` variants are brought to the kernel's
``(2, 1)`` contraction by swapping n axes of a view, which the kernel
reads through its strides: nothing is copied.

The JAX package also routes only this case to its kernel, and further
demands ``d % 128 == 0`` and a (n, n, d) block under 4 MB
(``cw_bmm_applicable``).  Those are the TPU's limits (the 128 lanes of
its vector unit and its VMEM budget); the CUDA kernel handles any ``d``
and ``n``, so the port keeps the structural conditions only.  Every other
contraction is a ``torch.einsum`` built from the dims, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import string

import torch

from ..kernels.channelwise_bmm import ChannelwiseBmm
from .matensor import MaskedTensor


def is_channelwise(A: MaskedTensor, dim1: int, B: MaskedTensor, dim2: int,
                   broadcast_firstdim: bool) -> bool:
    """The structural conditions under which the product is K5's."""
    return (broadcast_firstdim and A.masked_dim == 3 and B.masked_dim == 3
            and A.dense_dim == 1 and B.dense_dim == 1
            and dim1 in (1, 2) and dim2 in (1, 2)
            and A.shape == B.shape and A.shape[1] == A.shape[2])


def _einsum_spec(A: MaskedTensor, dim1: int, B: MaskedTensor, dim2: int,
                 broadcast_firstdim: bool) -> str:
    letters = iter(string.ascii_lowercase)
    k = next(letters)          # contracted index
    dense = "".join(next(letters) for _ in range(A.dense_dim))
    batch = ""
    if broadcast_firstdim:
        if dim1 <= 0 or dim2 <= 0:
            raise ValueError("dim 0 is the broadcast batch dim")
        batch = next(letters)

    def subs(T: MaskedTensor, dim: int):
        sub, out = [], []
        for i in range(T.masked_dim):
            if i == 0 and broadcast_firstdim:
                sub.append(batch)
            elif i == dim:
                sub.append(k)
            else:
                c = next(letters)
                sub.append(c)
                out.append(c)
        return "".join(sub) + dense, "".join(out)

    a_spec, a_out = subs(A, dim1)
    b_spec, b_out = subs(B, dim2)
    return f"{a_spec},{b_spec}->{batch}{a_out}{b_out}{dense}"


def mamamm(A: MaskedTensor, dim1: int, B: MaskedTensor, dim2: int,
           mask: torch.Tensor,
           broadcast_firstdim: bool = True) -> MaskedTensor:
    """Contract masked dim ``dim1`` of ``A`` with masked dim ``dim2`` of
    ``B``; the result carries ``mask``.

    Output masked shape: ``(batch?, *A.maskedshape minus dim1,
    *B.maskedshape minus dim2)``, with the dense dims shared elementwise.
    Only f32 is ported.
    """
    if A.dense_dim != B.dense_dim:
        raise ValueError("dense dims must match")
    tA = A.fill_masked(0.0)
    tB = B.fill_masked(0.0)
    if is_channelwise(A, dim1, B, dim2, broadcast_firstdim):
        a = tA if dim1 == 2 else tA.transpose(1, 2)
        b = tB if dim2 == 1 else tB.transpose(1, 2)
        return MaskedTensor(ChannelwiseBmm.apply(a, b), mask)
    spec = _einsum_spec(A, dim1, B, dim2, broadcast_firstdim)
    return MaskedTensor(torch.einsum(spec, tA, tB), mask)
