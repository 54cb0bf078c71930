"""K3: K1's contraction ``out[t] += U[u] * V[v]`` on a window schedule,
its host planner, its three roles, and the ``torch.autograd.Function``
that ties them together.

K3 computes what K1 (``spspmm_sum.py``) computes, over the same triples
``(t, u, v)`` sorted by the output row ``t``.  Only the schedule differs:
the host cuts the output rows into *groups* of consecutive rows and gives
each group an ordered list of V *windows* ``(base, rows)``, so that all
the group's rows that read one community's edge block read it from one
window.  A block of
the kernel (``csrc/window_spspmm.cu``) stages each window of its group in
shared memory once, and every output row of the group reads V from there;
U rows are gathered from device memory, as in K1.

The three roles, each a contraction over its own triples sorted by its
output row (the orders of ``hodata/loader.py:backward_orders``):

- forward, ``FWD``: ``out[a] += X[c] * A[d]`` over ``(a, c, d)``;
- ``DX``: ``dX[c] += g[a] * A[d]`` over ``(c, a, d)``;
- ``DA``: ``dA[d] += X[c] * g[a]`` over ``(d, c, a)``: its windows are
  over the tuple rows of ``g``.

They replace the TPU kernel ``pygho_tpu/kernels/strip_spspmm.py:689``
``_strip_kernel_pv``, which ran K1's strip contraction with persistent V
windows (``build_strip_plan(..., v_persistent=True)``, merge loop
``:363-394``, schedule ``_build_v_sched`` ``:199``) in the three roles of
``fused_spspmm_strip`` on pv plans.  The planner here ports *what* those
decide (which output rows share which V window), not the TPU plan format:
no strips, slots or DMA schedule.

The raw wrapper :func:`contract` launches a role's kernel for tensors on a
CUDA device and runs the plain PyTorch version (K1's
:func:`~pygho_tpu_torch.kernels.spspmm_sum.contract_plain` over the plan's
triples) for tensors on the CPU; on a CUDA tensor it launches the kernel
or raises.  It builds no autograd graph; :class:`WindowSpspmmSum` is the
differentiable entry point.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build
from .spspmm_sum import Role, contract_plain

SOURCE = "pygho_tpu_torch/csrc/window_spspmm.cu"
# channels of a block's slice: one f32 channel a lane of a warp
SLICE = 32
# shared memory a block may hold on Hopper (232,448 bytes of the SM's 256 KB)
MAX_SMEM_BYTES = 232448
# default window capacity in rows: a 512-row window of a 32-channel slice
# is 64 KB of shared memory, so three blocks share an SM and one block's
# window load runs under the others' sums
DEFAULT_CAP = 512
# a group takes the rows whose triples start within one run of this many
# triples: about 280 groups (1,100 blocks at D = 128) on the giant graph
DEFAULT_GROUP_TRIPLES = 2048
# and at most this many rows, so that a run of empty rows (the padded
# tail) spreads over many blocks
GROUP_ROWS = 1024

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

_PLAN_ARRAYS = ("tuv", "u", "vloc", "piece_ptr", "piece_row", "win_base",
                "win_rows", "win_piece", "grp_win", "grp_rows")


@dataclasses.dataclass
class WindowPlan:
    """One role's window schedule, as int32 arrays (numpy on the host,
    torch tensors after :meth:`to`).

    - ``tuv`` ``(3, k)``: the real triples ``(t, u, v)`` sorted by ``t``,
      as given (the plain version's input);
    - groups ``g``: output rows ``grp_rows[g]:grp_rows[g+1]`` and windows
      ``grp_win[g]:grp_win[g+1]``;
    - windows ``w``: V rows ``win_base[w]:win_base[w] + win_rows[w]`` and
      pieces ``win_piece[w]:win_piece[w+1]``;
    - pieces ``p``: one output row's triples that read one window,
      ``piece_ptr[p]:piece_ptr[p+1]`` of ``u`` and ``vloc`` (``v`` made
      window-local).  ``piece_row[p]`` is the row where the piece is the
      row's first (the block stores its sum), and ``~row`` (negative)
      where it adds to the pieces of earlier windows.  Every output row
      has a first piece; a row with no triples has one empty piece.
    """

    tuv: object
    u: object
    vloc: object
    piece_ptr: object
    piece_row: object
    win_base: object
    win_rows: object
    win_piece: object
    grp_win: object
    grp_rows: object
    out_rows: int
    u_rows: int
    v_rows: int
    cap: int
    max_rows: int      # the most rows of any window: a block's shared memory

    @property
    def n_groups(self) -> int:
        return int(self.grp_win.shape[0]) - 1

    @property
    def n_windows(self) -> int:
        return int(self.win_base.shape[0])

    @property
    def n_pieces(self) -> int:
        return int(self.piece_row.shape[0])

    def to(self, device) -> "WindowPlan":
        """The plan with its arrays as int32 tensors on ``device``."""
        arrays = {name: torch.as_tensor(np.asarray(getattr(self, name)),
                                        dtype=torch.int32).to(device)
                  .contiguous() for name in _PLAN_ARRAYS}
        return dataclasses.replace(self, **arrays)


def _windows(vs: np.ndarray, cap: int) -> List[Tuple[int, int]]:
    """``(base, rows)`` windows of at most ``cap`` rows covering the
    sorted distinct V rows ``vs`` of one group, in ascending order.

    Runs of rows with gaps of at most ``cap // 8`` are clusters; adjacent
    clusters merge greedily while the union of their spans fits ``cap``
    (the JAX merge loop's union-span rule, ``strip_spspmm.py:363-394``),
    so a stray row far from a community's block gets a small window of its
    own instead of cutting the block; a cluster wider than ``cap`` is cut
    greedily."""
    cut = np.flatnonzero(np.diff(vs) > max(cap // 8, 1)) + 1
    los = vs[np.r_[0, cut]]
    his = vs[np.r_[cut - 1, vs.size - 1]]
    out: List[Tuple[int, int]] = []
    lo = hi = None
    for clo, chi in zip(los.tolist(), his.tolist()):
        if lo is not None and chi - lo < cap:
            hi = chi
            continue
        if lo is not None:
            out.append((lo, hi - lo + 1))
        lo, hi = clo, chi
        while hi - lo >= cap:       # a cluster wider than one window
            last = int(vs[np.searchsorted(vs, lo + cap) - 1])
            out.append((lo, last - lo + 1))
            lo = int(vs[np.searchsorted(vs, lo + cap)])
    if lo is not None:
        out.append((lo, hi - lo + 1))
    return out


def _group_ends(rowptr: np.ndarray, budget: int,
                max_rows: int) -> np.ndarray:
    """The row where each group ends: consecutive rows whose first triple
    falls in one run of ``budget`` triples form a group, cut again every
    ``max_rows`` rows."""
    n = rowptr.shape[0] - 1
    rows = np.arange(n, dtype=np.int64)
    key = (rowptr[:-1] // budget) * (n + 1) + rows // max_rows
    return np.r_[np.flatnonzero(key[1:] != key[:-1]) + 1, n] if n \
        else np.zeros(0, np.int64)


def build_window_plan(tuv: np.ndarray, out_rows: int, u_rows: int,
                      v_rows: int, cap: int = DEFAULT_CAP,
                      group_triples: int = DEFAULT_GROUP_TRIPLES
                      ) -> WindowPlan:
    """One role's window plan from its real triples ``tuv`` ``(3, k)``
    sorted by the output row ``t`` (the forward ``acd``, or an order of
    ``backward_orders``), over ``out_rows`` output rows and operands of
    ``u_rows`` and ``v_rows`` rows; windows hold at most ``cap`` V rows.

    Groups are runs of about ``group_triples`` triples and at most
    ``GROUP_ROWS`` rows (:func:`_group_ends`); each group's windows cover
    the V rows its triples read (:func:`_windows`).  A row whose triples
    read several windows is split into one piece per window, in window
    order, and the block that owns the group sums the pieces: every output
    row is written by one block, with no atomics.  Within a piece the
    triples keep their given order."""
    tuv = np.asarray(tuv, dtype=np.int64)
    if tuv.ndim != 2 or tuv.shape[0] != 3:
        raise ValueError(f"triples must be (3, k), got {tuv.shape}")
    t, u, v = tuv
    k = t.size
    if min(cap, group_triples) < 1:
        raise ValueError("cap and group_triples must be at least 1")
    if k:
        if np.any(np.diff(t) < 0):
            raise ValueError("triples are not sorted by the output row")
        for name, idx, rows in (("t", t, out_rows), ("u", u, u_rows),
                                ("v", v, v_rows)):
            if idx.min() < 0 or idx.max() >= rows:
                raise ValueError(f"{name} out of range [0, {rows})")
    rowptr = np.zeros(out_rows + 1, np.int64)
    np.cumsum(np.bincount(t, minlength=out_rows), out=rowptr[1:])
    has = rowptr[1:] > rowptr[:-1]
    ends = _group_ends(rowptr, group_triples, GROUP_ROWS)
    grp_rows = np.r_[0, ends]
    grp_of_row = np.repeat(np.arange(ends.size), np.diff(grp_rows))

    # each group's windows; a group with no triples gets one empty window
    win_base: List[int] = []
    win_rows: List[int] = []
    grp_win = np.zeros(ends.size + 1, np.int64)
    win_of = np.zeros(k, np.int64)          # global window of each triple
    for g in range(ends.size):
        s, e = rowptr[grp_rows[g]], rowptr[grp_rows[g + 1]]
        wins = _windows(np.unique(v[s:e]), cap) if e > s else [(0, 0)]
        if e > s:
            bases = np.asarray([b for b, _ in wins], np.int64)
            win_of[s:e] = len(win_base) + np.searchsorted(
                bases, v[s:e], side="right") - 1
        for b, r in wins:
            win_base.append(b)
            win_rows.append(r)
        grp_win[g + 1] = len(win_base)
    win_base_a = np.asarray(win_base, np.int64)
    win_rows_a = np.asarray(win_rows, np.int64)

    # pieces: triples ordered by (window, row), stable, so each piece is a
    # run of one row's triples in their given order; rows with no triples
    # get an empty piece in their group's first window
    order = np.lexsort((t, win_of))
    ts, ws = t[order], win_of[order]
    brk = np.flatnonzero((ts[1:] != ts[:-1]) | (ws[1:] != ws[:-1])) + 1
    p_start = np.r_[0, brk] if k else np.zeros(0, np.int64)
    p_row, p_win = ts[p_start], ws[p_start]
    p_len = np.diff(np.r_[p_start, k])
    empty = np.flatnonzero(~has)
    rows_all = np.r_[p_row, empty]
    wins_all = np.r_[p_win, grp_win[grp_of_row[empty]]]
    len_all = np.r_[p_len, np.zeros(empty.size, np.int64)]
    po = np.lexsort((rows_all, wins_all))
    rows_all, wins_all, len_all = rows_all[po], wins_all[po], len_all[po]
    # a row's first piece is the one of its lowest window
    by_row = np.lexsort((wins_all, rows_all))
    first = np.ones(rows_all.size, bool)
    first[by_row[1:]] = rows_all[by_row[1:]] != rows_all[by_row[:-1]]
    piece_row = np.where(first, rows_all, ~rows_all)
    piece_ptr = np.r_[0, np.cumsum(len_all)]
    win_piece = np.searchsorted(wins_all, np.arange(win_base_a.size + 1))
    i32 = np.int32
    return WindowPlan(
        tuv=np.ascontiguousarray(tuv, dtype=i32),
        u=u[order].astype(i32), vloc=(v - win_base_a[win_of])[order]
        .astype(i32), piece_ptr=piece_ptr.astype(i32),
        piece_row=piece_row.astype(i32), win_base=win_base_a.astype(i32),
        win_rows=win_rows_a.astype(i32), win_piece=win_piece.astype(i32),
        grp_win=grp_win.astype(i32), grp_rows=grp_rows.astype(i32),
        out_rows=int(out_rows), u_rows=int(u_rows), v_rows=int(v_rows),
        cap=int(cap), max_rows=int(win_rows_a.max(initial=0)))


def build_window_plans(acd: np.ndarray, x_rows: int, a_rows: int,
                       out_rows: int, cap: int = DEFAULT_CAP,
                       group_triples: int = DEFAULT_GROUP_TRIPLES
                       ) -> Tuple[WindowPlan, WindowPlan, WindowPlan]:
    """The (forward, dX, dA) window plans of real ``acd`` triples sorted
    by ``a``: the forward over ``(a, c, d)``, dX over ``(c, a, d)`` and dA
    over ``(d, c, a)`` in the stable orders of ``backward_orders`` (the
    counterpart of ``build_spspmm_strip_plans`` on a pv geometry)."""
    acd = np.asarray(acd, dtype=np.int64)
    a, c, d = acd
    kw = dict(cap=cap, group_triples=group_triples)
    fwd = build_window_plan(acd, out_rows, x_rows, a_rows, **kw)
    o = np.argsort(c, kind="stable")
    dx = build_window_plan(np.stack([c[o], a[o], d[o]]), x_rows, out_rows,
                           a_rows, **kw)
    o = np.argsort(d, kind="stable")
    da = build_window_plan(np.stack([d[o], c[o], a[o]]), a_rows, x_rows,
                           out_rows, **kw)
    return fwd, dx, da


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_spspmm")
    for role in ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(U, V, plan: WindowPlan):
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
                             f"tensor on {U.device} (WindowPlan.to)")
    if plan.tuv.shape[1] >= 2 ** 31:
        raise ValueError("more triples than int32 indices can address")
    if torch.is_grad_enabled() and (U.requires_grad or V.requires_grad):
        raise RuntimeError(
            "the raw K3 wrapper builds no autograd graph, and its input "
            "requires grad: call WindowSpspmmSum.apply, or run under "
            "torch.no_grad()")


def contract(role: Role, U: torch.Tensor, V: torch.Tensor,
             plan: WindowPlan) -> torch.Tensor:
    """One role of K3, ``out[t] = sum over (t, u, v) of U[u] * V[v]``, as
    an ``(plan.out_rows, D)`` float32 tensor, on ``plan``'s schedule (on
    the device of ``U``; rows with no triples come out 0)."""
    _check(U, V, plan)
    D = U.shape[1]
    if U.device.type == "cpu":
        return contract_plain(U, V, plan.tuv, plan.out_rows)
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    out = torch.empty(plan.out_rows, D, dtype=torch.float32,
                      device=U.device)
    if plan.out_rows == 0:
        return out
    smem = plan.max_rows * SLICE * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a window of {plan.max_rows} rows needs {smem} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}: "
                         f"build the plan with a smaller cap")
    with torch.cuda.device(U.device):
        fn = getattr(_lib(), role.NAME)
        rc = fn(U.data_ptr(), V.data_ptr(), plan.u.data_ptr(),
                plan.vloc.data_ptr(), plan.piece_ptr.data_ptr(),
                plan.piece_row.data_ptr(), plan.win_base.data_ptr(),
                plan.win_rows.data_ptr(), plan.win_piece.data_ptr(),
                plan.grp_win.data_ptr(), out.data_ptr(), plan.n_groups, D,
                plan.max_rows, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1
    return out


# the (forward, dX, dA) plans of one contraction, on the operands' device
WindowPlans = Tuple[WindowPlan, WindowPlan, WindowPlan]


class WindowSpspmmSum(torch.autograd.Function):
    """Differentiable K3: ``WindowSpspmmSum.apply(X, A, plans)``,
    ``out[a] = sum over (a, c, d) of X[c] * A[d]``.

    Forward: the forward role.  Backward: the dX role gives ``grad_X``
    and the dA role gives ``grad_A``, each run only where
    ``ctx.needs_input_grad`` asks for it (the counterpart of
    ``fused_spspmm_strip``'s ``_bwd_rule`` on pv plans).  The incoming
    gradient is taken in f32."""

    @staticmethod
    def forward(ctx, X, A, plans: WindowPlans):
        fwd, dx, da = plans
        if dx.out_rows != X.shape[0] or da.out_rows != A.shape[0] \
                or dx.u_rows != fwd.out_rows or da.v_rows != fwd.out_rows:
            raise ValueError("the dX and dA plans do not match the forward "
                             "plan and the operands")
        ctx.save_for_backward(X, A)
        ctx.plans = plans
        return contract(FWD, X, A, fwd)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        X, A = ctx.saved_tensors
        _, dx, da = ctx.plans
        g = g.to(torch.float32).contiguous()
        dX = contract(DX, g, A, dx) if ctx.needs_input_grad[0] else None
        dA = contract(DA, X, g, da) if ctx.needs_input_grad[1] else None
        return dX, dA, None
