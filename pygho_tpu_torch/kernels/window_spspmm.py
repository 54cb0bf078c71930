"""K3: K1's contraction ``out[t] += U[u] * V[v]`` as a short-row gather,
its host plan, its three roles, and the ``torch.autograd.Function`` that
ties them together.

K3 computes what K1 (``spspmm_sum.py``) computes, over the same triples
``(t, u, v)`` sorted by the output row ``t``, with the same row pointer.
Only the schedule differs: K1 gives each output row a warp, and K3 gives
each warp a *chunk* of rows, the rows whose first triple lies in one run
of 32 triples (at most ``CHUNK_ROWS`` rows), so that a warp gathers 32
triples' rows at once where K1's warp gathers a row's two or three.  That
suits the giant graph, whose rows hold about 2.4 triples
(``csrc/window_spspmm.cu``).

The three roles, each a contraction over its own triples sorted by its
output row (the orders of ``hodata/loader.py:backward_orders``):

- forward, ``FWD``: ``out[a] += X[c] * A[d]`` over ``(a, c, d)``;
- ``DX``: ``dX[c] += g[a] * A[d]`` over ``(c, a, d)``;
- ``DA``: ``dA[d] += X[c] * g[a]`` over ``(d, c, a)``.

They replace the TPU kernel ``pygho_tpu/kernels/strip_spspmm.py:689``
``_strip_kernel_pv``, which ran K1's strip contraction with persistent V
windows (``build_strip_plan(..., v_persistent=True)``) in the three roles
of ``fused_spspmm_strip`` on pv plans.  The windows are not ported: they
gave a TPU core, which gathers only through one-hot products over VMEM,
the reuse of an edge block across grid steps, and on an H100 the 50 MB L2
gives that reuse to a kernel that gathers by index.  A first version that
staged V windows in shared memory took 3.3x to 4.1x K1's time on the same
triples (``PERF.md``); the kernel keeps its name and module so that
reports and traces stay comparable.

Each role comes in two variants, chosen by the math mode, as the JAX
kernel's ``_strip_math`` computes them (``strip_spspmm.py:653-686``), on
f32 operands in both (the JAX user, ``tuple_parallel.py:985-986``, casts
them):

- f32, exact (the base roles ``FWD``, ``DX``, ``DA``): f32 products
  summed in f32;
- f32, fast (``*_f32fast``, ``exact=False``): both operands rounded to
  bf16, their product formed in f32 and rounded to bf16 again, the terms
  summed in f32.  In dX and dA the cotangent is an operand and is rounded
  too, as ``_bwd_rule`` (``:1124-1132``) passes ``exact`` to both.

The raw wrapper :func:`contract` launches a role's kernel for tensors on a
CUDA device and runs the plain PyTorch version (K1's
:func:`~pygho_tpu_torch.kernels.spspmm_sum.contract_plain` over the plan's
triples, in the same mode) for tensors on the CPU; on a CUDA tensor it
launches the kernel of the mode's variant or raises.  It builds no autograd graph; :class:`WindowSpspmmSum` is the
differentiable entry point.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .spspmm_sum import Role, add_variants, contract_plain

SOURCE = "pygho_tpu_torch/csrc/window_spspmm.cu"
# a warp's chunk: the rows whose first triple lies in one run of this many
# triples (one (u, v) pair a lane) ...
CHUNK_TRIPLES = 32
# ... and at most this many rows (one row end a lane)
CHUNK_ROWS = 32

FWD = Role("window_spspmm_fwd_f32",
           "pygho_tpu/kernels/strip_spspmm.py:689 (_strip_kernel_pv, "
           "forward role on the pv forward plan, :1092)", SOURCE)
DX = Role("window_spspmm_dx_f32",
          "pygho_tpu/kernels/strip_spspmm.py:689 (_strip_kernel_pv, dX "
          "role on the pv dX plan, :1095; _bwd_rule :1127)", SOURCE)
DA = Role("window_spspmm_da_f32",
          "pygho_tpu/kernels/strip_spspmm.py:689 (_strip_kernel_pv, dA "
          "role on the pv dA plan, :1097; _bwd_rule :1130)", SOURCE)
ROLES = (FWD, DX, DA)
FAST_ROLES = add_variants(ROLES, (("f32fast", torch.float32, False),))

_PLAN_ARRAYS = ("tuv", "rowptr", "warp_row")


@dataclasses.dataclass
class ChunkPlan:
    """One role's plan, as int32 arrays (numpy on the host, torch tensors
    after :meth:`to`):

    - ``tuv`` ``(3, k)``: the triples ``(t, u, v)`` sorted by ``t``, as
      given (the kernel reads ``u`` and ``v``; the plain version all
      three);
    - ``rowptr`` ``(out_rows + 1,)``: the CSR row pointer of ``t``;
    - ``warp_row`` ``(n_warps + 1,)``: warp ``w`` owns the output rows
      ``warp_row[w]:warp_row[w + 1]`` (:func:`warp_chunks`)."""

    tuv: object
    rowptr: object
    warp_row: object
    out_rows: int
    u_rows: int
    v_rows: int

    @property
    def n_warps(self) -> int:
        return int(self.warp_row.shape[0]) - 1

    def to(self, device) -> "ChunkPlan":
        """The plan with its arrays as int32 tensors on ``device``."""
        arrays = {name: torch.as_tensor(np.asarray(getattr(self, name)),
                                        dtype=torch.int32).to(device)
                  .contiguous() for name in _PLAN_ARRAYS}
        return dataclasses.replace(self, **arrays)


def warp_chunks(rowptr: np.ndarray) -> np.ndarray:
    """The first row of each warp's chunk, and the row count at the end.

    Row ``r`` belongs to the chunk of triples ``rowptr[r] // 32``: the
    chunk that holds its first triple or, for a row with no triples, the
    position where it would start.  Each run of rows in one chunk is one
    warp's, cut into runs of at most ``CHUNK_ROWS`` rows.  A row longer
    than a chunk stays with the warp where it starts."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    rows = rowptr.shape[0] - 1
    if rows <= 0:
        return np.zeros(1, np.int64)
    chunk = rowptr[:-1] // CHUNK_TRIPLES
    starts = np.flatnonzero(np.r_[True, chunk[1:] != chunk[:-1]])
    lens = np.diff(np.r_[starts, rows])
    pieces = (lens + CHUNK_ROWS - 1) // CHUNK_ROWS
    first = np.cumsum(pieces) - pieces
    step = np.arange(int(pieces.sum())) - np.repeat(first, pieces)
    return np.r_[np.repeat(starts, pieces) + CHUNK_ROWS * step, rows]


def build_chunk_plan(tuv: np.ndarray, out_rows: int, u_rows: int,
                     v_rows: int) -> ChunkPlan:
    """One role's plan from its real triples ``tuv`` ``(3, k)`` sorted by
    the output row ``t`` (the forward ``acd``, or an order of
    ``backward_orders``), over ``out_rows`` output rows and operands of
    ``u_rows`` and ``v_rows`` rows: the triples as given, their row
    pointer (``hodata.loader.row_pointer``) and the warps' chunks."""
    # imported here: hodata's loader imports the model layers, which
    # import this package
    from ..hodata.loader import row_pointer

    tuv = np.asarray(tuv, dtype=np.int64)
    if tuv.ndim != 2 or tuv.shape[0] != 3:
        raise ValueError(f"triples must be (3, k), got {tuv.shape}")
    if tuv.shape[1] >= 2 ** 31:
        raise ValueError("more triples than int32 indices can address")
    t = tuv[0]
    if t.size:
        if np.any(np.diff(t) < 0):
            raise ValueError("triples are not sorted by the output row")
        for name, idx, rows in (("t", t, out_rows), ("u", tuv[1], u_rows),
                                ("v", tuv[2], v_rows)):
            if idx.min() < 0 or idx.max() >= rows:
                raise ValueError(f"{name} out of range [0, {rows})")
    rowptr = row_pointer(t, out_rows)
    return ChunkPlan(tuv=np.ascontiguousarray(tuv, dtype=np.int32),
                     rowptr=rowptr,
                     warp_row=warp_chunks(rowptr).astype(np.int32),
                     out_rows=int(out_rows), u_rows=int(u_rows),
                     v_rows=int(v_rows))


def build_chunk_plans(acd: np.ndarray, x_rows: int, a_rows: int,
                      out_rows: int
                      ) -> Tuple[ChunkPlan, ChunkPlan, ChunkPlan]:
    """The (forward, dX, dA) plans of real ``acd`` triples sorted by
    ``a``: the forward over ``(a, c, d)``, dX over ``(c, a, d)`` and dA
    over ``(d, c, a)`` in the stable orders of ``backward_orders``, the
    orders K1's training batches carry."""
    from ..hodata.loader import backward_orders

    acd = np.asarray(acd, dtype=np.int64)
    orders = backward_orders(acd, x_rows, a_rows)
    return (build_chunk_plan(acd, out_rows, x_rows, a_rows),
            build_chunk_plan(orders["dx"][0], x_rows, out_rows, a_rows),
            build_chunk_plan(orders["da"][0], a_rows, x_rows, out_rows))


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_spspmm")
    for role in ROLES + FAST_ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(U, V, plan: ChunkPlan):
    for name, t in (("U", U), ("V", V)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (rows, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if V.device != U.device:
        raise ValueError(f"V is on {V.device}, U on {U.device}")
    if U.shape[1] != V.shape[1] or U.shape[1] == 0:
        raise ValueError(f"U and V must share one D >= 1, got "
                         f"{tuple(U.shape)} and {tuple(V.shape)}")
    if U.shape[0] != plan.u_rows or V.shape[0] != plan.v_rows:
        raise ValueError(f"the plan is for operands of {plan.u_rows} and "
                         f"{plan.v_rows} rows, U and V have {U.shape[0]} "
                         f"and {V.shape[0]}")
    for name in _PLAN_ARRAYS:
        a = getattr(plan, name)
        if not torch.is_tensor(a) or a.device != U.device \
                or a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f"plan array {name} must be a contiguous int32 "
                             f"tensor on {U.device} (ChunkPlan.to)")
    if torch.is_grad_enabled() and (U.requires_grad or V.requires_grad):
        raise RuntimeError(
            "the raw K3 wrapper builds no autograd graph, and its input "
            "requires grad: call WindowSpspmmSum.apply, or run under "
            "torch.no_grad()")


def contract(role: Role, U: torch.Tensor, V: torch.Tensor,
             plan: ChunkPlan, exact: bool = True) -> torch.Tensor:
    """One role of K3, ``out[t] = sum over (t, u, v) of U[u] * V[v]``, as
    an ``(plan.out_rows, D)`` float32 tensor, on ``plan``'s chunks (on the
    device of ``U``; rows with no triples come out 0), in the variant of
    ``role`` that ``exact`` selects (module docstring)."""
    _check(U, V, plan)
    role = role.variant(torch.float32, exact)
    D = U.shape[1]
    if U.device.type == "cpu":
        return contract_plain(U, V, plan.tuv, plan.out_rows, role.EXACT)
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    out = torch.empty(plan.out_rows, D, dtype=torch.float32,
                      device=U.device)
    if plan.out_rows == 0:
        return out
    with torch.cuda.device(U.device):
        fn = getattr(_lib(), role.NAME)
        rc = fn(U.data_ptr(), V.data_ptr(), plan.tuv[1].data_ptr(),
                plan.tuv[2].data_ptr(), plan.rowptr.data_ptr(),
                plan.warp_row.data_ptr(), out.data_ptr(), plan.n_warps, D,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1
    return out


# the (forward, dX, dA) plans of one contraction, on the operands' device
ChunkPlans = Tuple[ChunkPlan, ChunkPlan, ChunkPlan]


class WindowSpspmmSum(torch.autograd.Function):
    """Differentiable K3: ``WindowSpspmmSum.apply(X, A, plans, exact)``,
    ``out[a] = sum over (a, c, d) of X[c] * A[d]``, ``exact`` True unless
    given.

    Forward: the forward role.  Backward: the dX role gives ``grad_X``
    and the dA role gives ``grad_A``, each run only where
    ``ctx.needs_input_grad`` asks for it, in the same math mode (the
    counterpart of ``fused_spspmm_strip``'s ``_bwd_rule`` on pv plans).
    The incoming gradient is taken in f32; in fast mode the dX and dA
    roles round it to bf16 as they read it."""

    @staticmethod
    def forward(ctx, X, A, plans: ChunkPlans, exact: bool = True):
        fwd, dx, da = plans
        if dx.out_rows != X.shape[0] or da.out_rows != A.shape[0] \
                or dx.u_rows != fwd.out_rows or da.v_rows != fwd.out_rows:
            raise ValueError("the dX and dA plans do not match the forward "
                             "plan and the operands")
        ctx.save_for_backward(X, A)
        ctx.plans = plans
        ctx.exact = exact
        return contract(FWD, X, A, fwd, exact)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        X, A = ctx.saved_tensors
        _, dx, da = ctx.plans
        g = g.to(torch.float32).contiguous()
        dX = contract(DX, g, A, dx, ctx.exact) \
            if ctx.needs_input_grad[0] else None
        dA = contract(DA, X, g, da, ctx.exact) \
            if ctx.needs_input_grad[1] else None
        return dX, dA, None, None