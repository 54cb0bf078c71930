"""K4: the softmax-attention aggregate of NGAT, its three gradient roles,
and the ``torch.autograd.Function`` that ties them together.

Over the triples ``(a, c, d)`` of a message-passing key, with the score
taken per channel and its product rounded in this order,

    s_k    = (a1[c_k] * aA[d_k]) * a2[a_k]
    M[a]   = max over the row's triples of s_k     (0 for an empty row)
    e_k    = exp(s_k - M[a_k])
    den[a] = sum_k e_k
    out[a] = sum_k e_k * a3[c_k] / den[a]          (0 for an empty row)

With ``gZ = g / den`` (0 where ``den`` is 0), ``goZ = gZ * out`` and
``ds_k = e_k * (a3[c_k] * gZ[a_k] - goZ[a_k])``, the gradients are four
segment sums, each over the triples in the order of its output rows:

- forward, ``FWD``: ``out``, ``den`` and ``M`` over ``(a, c, d)``;
- ``DW``: ``d_a2[a] += (ds * a1[c]) * aA[d]`` over ``(a, c, d)``;
- ``DC``: ``d_a1[c] += (ds * aA[d]) * a2[a]`` and
  ``d_a3[c] += e * gZ[a]`` over ``(c, a, d)``;
- ``DV``: ``d_aA[d] += (ds * a1[c]) * a2[a]`` over ``(d, c, a)``.

``M`` is a shift that cancels in the ratio, so no gradient flows through
it.  The host gives each role its triples already in that order, with the
padding stripped and a row pointer built (``hodata.loader.add_rowptr``:
the backward orders are K1's), so every output row is one segment and no
role needs atomics.

The shift is the one departure from the TPU kernel's arithmetic.  That
kernel shifts each row by a bound, ``|a2[a]| * max|a1| * max|aA|``,
because one pass over one-hot windows cannot take a row's maximum, and
where the bound overshoots by more than about 60 nats its denominator
falls under a floor and the row comes out 0 (or NaN in its poison mode).
Here the rows arrive sorted with a row pointer, so the shift is the exact
per-row, per-channel maximum, as the JAX package's unfused path
(``segment_softmax(stable="segment")``) takes it: ``den >= 1`` on every
row with triples, and no floor, mask or poison mode is needed.  On every
row where the TPU kernel does not flush, the two agree up to rounding.

The raw wrapper :func:`attend` launches a role's hand-written CUDA kernel
(``csrc/segment_attention.cu``) for tensors on a CUDA device and runs the
plain PyTorch version :func:`attention_plain` for tensors on the CPU.
There is no fallback: on a CUDA tensor it launches the kernel or raises.
The raw wrapper builds no autograd graph, so it refuses a tensor that
requires grad while grad mode is on; :class:`SegmentAttention` is the
differentiable entry point, on both devices, and runs the same four
roles.

They replace the four roles of the TPU kernel
``pygho_tpu/kernels/strip_attention.py:_att_kernel`` behind
``fused_attention_strip``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..backend.segment import segment_reduce
from . import _build
from .spspmm_sum import BackwardOrders, Role

SOURCE = "pygho_tpu_torch/csrc/segment_attention.cu"

# each role's chunk of triples a warp (csrc/chunk_walk.cuh), from a sweep
# of 8, 16 and 32 on the card at the main path's shape
# (scripts/k1_k4_ab_gpu.py)
FWD = Role("seg_att_fwd_f32",
           "pygho_tpu/kernels/strip_attention.py:161 (_att_kernel, fwd "
           "role, math _att_math :83; _att_fwd :483)", SOURCE, chunk=16)
DW = Role("seg_att_dw_f32",
          "pygho_tpu/kernels/strip_attention.py:161 (_att_kernel, dw role "
          "on the forward plan; _att_bwd :511)", SOURCE, chunk=16)
DC = Role("seg_att_dc_f32",
          "pygho_tpu/kernels/strip_attention.py:161 (_att_kernel, dc role "
          "on the dX plan; _att_bwd :511)", SOURCE, chunk=8)
DV = Role("seg_att_dv_f32",
          "pygho_tpu/kernels/strip_attention.py:161 (_att_kernel, dv role "
          "on the dA plan; _att_bwd :511)", SOURCE, chunk=8)
ROLES = (FWD, DW, DC, DV)

# where a, c and d stand in each role's triples (t, u, v)
ACD_POSITIONS = {FWD: (0, 1, 2), DW: (0, 1, 2), DC: (1, 0, 2),
                 DV: (2, 1, 0)}


def attention_plain(role: Role, a1: torch.Tensor, a3: torch.Tensor,
                    aA: torch.Tensor, a2: torch.Tensor, tuv: torch.Tensor,
                    out_rows: int, M: Optional[torch.Tensor] = None,
                    gZ: Optional[torch.Tensor] = None,
                    goZ: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of every role: gather, score, exact
    segment maximum (forward) or the given ``M`` (gradients), exp, segment
    sums over the role's triples ``tuv``.  Returns ``(out, den, M)`` for
    ``FWD``, ``(d_a2,)`` for ``DW``, ``(d_a1, d_a3)`` for ``DC`` and
    ``(d_aA,)`` for ``DV``, each with ``out_rows`` rows."""
    idx = tuv.long()
    a, c, d = (idx[i] for i in ACD_POSITIONS[role])
    t = idx[0]
    w, x1, av = a2[a], a1[c], aA[d]
    s = (x1 * av) * w
    if role is FWD:
        # the shift is a constant of the softmax: not differentiated
        M = segment_reduce(s.detach(), t, out_rows, "max")
        e = torch.exp(s - M[t])
        den = segment_reduce(e, t, out_rows, "sum")
        num = segment_reduce(e * a3[c], t, out_rows, "sum")
        # an empty row has num = den = 0 and gives 0
        return num / torch.where(den > 0, den, 1.0), den, M
    e = torch.exp(s - M[a])
    ds = e * (a3[c] * gZ[a] - goZ[a])
    if role is DW:
        return (segment_reduce((ds * x1) * av, t, out_rows, "sum"),)
    if role is DC:
        return (segment_reduce((ds * av) * w, t, out_rows, "sum"),
                segment_reduce(e * gZ[a], t, out_rows, "sum"))
    return (segment_reduce((ds * x1) * w, t, out_rows, "sum"),)


def softmax_cotangents(g: torch.Tensor, out: torch.Tensor,
                       den: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``gZ = g / den`` (0 on a row with no triples, where ``den`` is 0)
    and ``goZ = gZ * out``: the gradient roles' per-row inputs for the
    cotangent ``g`` of the forward's ``out``."""
    nonempty = den > 0
    gZ = torch.where(nonempty, g.to(torch.float32)
                     / torch.where(nonempty, den, 1.0), 0.0)
    return gZ, gZ * out


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_attention")
    for role in ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(role, a1, a3, aA, a2, tuv, rowptr, M, gZ, goZ):
    ops = {"a1": a1, "a3": a3, "aA": aA, "a2": a2}
    if role is not FWD:
        ops.update(M=M, gZ=gZ, goZ=goZ)
    for name, x in ops.items():
        if x is None:
            raise ValueError(f"{role.NAME} needs {name}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    D = a1.shape[-1] if a1.dim() == 2 else -1
    for name, x in ops.items():
        rows = aA.shape[0] if name == "aA" else a1.shape[0]
        if x.dim() != 2 or x.shape != (rows, D):
            raise ValueError(
                f"{name} is {tuple(x.shape)}; a1, a3, a2 (and M, gZ, goZ) "
                f"must be (x_rows, D) and aA (e_rows, D) with one D")
    if D == 0:
        raise ValueError("D must be at least 1")
    for name, x in list(ops.items()) + [("tuv", tuv), ("rowptr", rowptr)]:
        if x.device != a1.device:
            raise ValueError(f"{name} is on {x.device}, a1 on {a1.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuv.dtype != torch.int32 or tuv.dim() != 2 or tuv.shape[0] != 3:
        raise ValueError(f"triples must be int32 (3, k), got {tuv.dtype} "
                         f"{tuple(tuv.shape)}")
    if tuv.shape[1] >= 2 ** 31:
        raise ValueError("more triples than int32 indices can address")
    rows = aA.shape[0] if role is DV else a1.shape[0]
    if rowptr.dtype != torch.int32 or rowptr.shape != (rows + 1,):
        raise ValueError(
            f"{role.NAME}: rowptr must be int32 ({rows + 1},) over the "
            f"role's {rows} output rows, got {rowptr.dtype} "
            f"{tuple(rowptr.shape)}")
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in ops.values()):
        raise RuntimeError(
            "the raw K4 wrapper builds no autograd graph, and its input "
            "requires grad: call SegmentAttention.apply (NGATConv does), "
            "or run under torch.no_grad()")


def attend(role: Role, a1: torch.Tensor, a3: torch.Tensor,
           aA: torch.Tensor, a2: torch.Tensor, tuv: torch.Tensor,
           rowptr: torch.Tensor, M: Optional[torch.Tensor] = None,
           gZ: Optional[torch.Tensor] = None,
           goZ: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """One role of K4, with :func:`attention_plain`'s outputs.

    ``a1``, ``a3``, ``a2``: ``(x_rows, D)`` float32; ``aA``:
    ``(e_rows, D)``; ``M``, ``gZ``, ``goZ`` (gradient roles only):
    ``(x_rows, D)``.  ``tuv``: int32 ``(3, k)`` real triples in the role's
    order (module docstring); ``rowptr``: their int32 row pointer over the
    role's output rows (``x_rows``, or ``e_rows`` for ``DV``).  Every
    index must be in range (checked on the host when the batch is built).
    """
    _check(role, a1, a3, aA, a2, tuv, rowptr, M, gZ, goZ)
    out_rows = rowptr.shape[0] - 1
    D = a1.shape[1]
    if a1.device.type == "cpu":
        if int(rowptr[-1]) != tuv.shape[1]:
            raise ValueError("rowptr does not cover the triples")
        return attention_plain(role, a1, a3, aA, a2, tuv, out_rows, M, gZ,
                               goZ)
    if a1.device.type != "cuda":
        raise ValueError(f"no kernel for device {a1.device}")
    n_out = {FWD: 3, DW: 1, DC: 2, DV: 1}[role]
    outs = tuple(torch.empty(out_rows, D, dtype=torch.float32,
                             device=a1.device) for _ in range(n_out))
    if out_rows == 0:
        return outs
    ptrs = [x.data_ptr() if x is not None else None
            for x in (a1, a3, aA, a2, M, gZ, goZ)]
    ptrs += [tuv[0].data_ptr(), tuv[1].data_ptr(), tuv[2].data_ptr(),
             rowptr.data_ptr()]
    ptrs += [x.data_ptr() for x in outs] + [None] * (3 - n_out)
    with torch.cuda.device(a1.device):
        fn = getattr(_lib(), role.NAME)
        rc = fn(*ptrs, tuv.shape[1], role.CHUNK, out_rows, D,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1
    return outs


class SegmentAttention(torch.autograd.Function):
    """Differentiable K4:
    ``SegmentAttention.apply(a1, a3, aA, a2, acd, rowptr, bwd)``.

    Forward: the forward role, which saves ``out``, ``den`` and ``M``.
    Backward: ``gZ`` and ``goZ`` in PyTorch, then ``DW`` gives
    ``grad_a2``, ``DC`` gives ``grad_a1`` and ``grad_a3``, and ``DV``
    gives ``grad_aA``, each run only where ``ctx.needs_input_grad`` asks
    for it (the counterpart of ``fused_attention_strip``'s ``_att_bwd``).
    ``bwd`` is K1's backward orders of the same triples
    (:data:`~.spspmm_sum.BackwardOrders`: ``(c, a, d)`` sorted by ``c``
    and ``(d, c, a)`` sorted by ``d``); without them the forward runs,
    and a backward through it raises.  The incoming gradient is taken in
    f32.
    """

    @staticmethod
    def forward(ctx, a1, a3, aA, a2, acd, rowptr,
                bwd: Optional[BackwardOrders]):
        if bwd is not None:
            _, rp_dc, _, rp_dv = bwd
            if rp_dc.shape[0] != a1.shape[0] + 1 \
                    or rp_dv.shape[0] != aA.shape[0] + 1:
                raise ValueError(
                    f"backward row pointers span {rp_dc.shape[0] - 1} and "
                    f"{rp_dv.shape[0] - 1} rows, a1 and aA have "
                    f"{a1.shape[0]} and {aA.shape[0]}")
        out, den, M = attend(FWD, a1, a3, aA, a2, acd, rowptr)
        ctx.save_for_backward(a1, a3, aA, a2, acd, rowptr, out, den, M)
        ctx.bwd = bwd
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a1, a3, aA, a2, acd, rowptr, out, den, M = ctx.saved_tensors
        if ctx.bwd is None:
            raise RuntimeError(
                "a gradient flows through the attention, but the batch has "
                "no backward orders: batch with SpDataloader(..., "
                "backward=True) (add_rowptr(..., backward=True))")
        cad, rp_dc, dca, rp_dv = ctx.bwd
        need = ctx.needs_input_grad
        gZ, goZ = softmax_cotangents(g, out, den)
        ops = (a1, a3, aA, a2)
        d_a2 = attend(DW, *ops, acd, rowptr, M, gZ, goZ)[0] \
            if need[3] else None
        d_a1 = d_a3 = None
        if need[0] or need[1]:
            d_a1, d_a3 = attend(DC, *ops, cad, rp_dc, M, gZ, goZ)
        d_aA = attend(DV, *ops, dca, rp_dv, M, gZ, goZ)[0] \
            if need[2] else None
        return (d_a1 if need[0] else None, d_a3 if need[1] else None,
                d_aA, d_a2, None, None, None)
