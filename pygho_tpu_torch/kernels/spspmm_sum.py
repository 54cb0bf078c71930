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

Each role comes in four variants, chosen by the operands' stored dtype
and the math mode (``kernels/numerics.py``), as the JAX kernel's
``_strip_math`` computes them (``strip_spspmm.py:653-686``):

- f32, exact (the base roles ``FWD``, ``DX``, ``DA``): f32 products
  summed in f32;
- f32, fast (``*_f32fast``, the ``--fused`` runs): both operands rounded
  to bf16, their product formed in f32 and rounded to bf16 again, the
  terms summed in f32;
- bf16, exact (``*_bf16``): the exact products of the bf16 values, summed
  in f32;
- bf16, fast (``*_bf16fast``): as f32 fast, on operands already in bf16.

Every variant writes f32.  In the gradient roles the cotangent ``g`` is
f32 whatever the operands are (the JAX ``_bwd_rule`` takes it so), so the
bf16 variants of dX and dA read one f32 operand beside a bf16 one.

The raw wrapper :func:`contract` launches a role's hand-written CUDA kernel
(``csrc/spspmm_sum.cu``) for tensors on a CUDA device and runs the plain
PyTorch version :func:`contract_plain` for tensors on the CPU.  There is
no fallback: on a CUDA tensor it launches the kernel of the variant the
operands and the mode ask for, or raises.  The raw wrapper builds no
autograd graph, so it refuses a tensor that requires grad while grad mode
is on; :class:`SpspmmSum` is the differentiable entry point, on both
devices, and runs the same three roles.

They replace the three roles of the TPU kernel
``pygho_tpu/kernels/strip_spspmm.py:_strip_kernel`` behind
``fused_spspmm_strip``, in its ``exact`` and fast modes and on f32 and bf16
operands.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

SOURCE = "pygho_tpu_torch/csrc/spspmm_sum.cu"

STORED = (torch.float32, torch.bfloat16)


class Role:
    """One role of a kernel: the name of its kernel (also its C entry
    point in ``SOURCE``, the CUDA file), the TPU kernel role it replaces,
    for kernels that take chunks of triples the triples of a warp's chunk
    (``CHUNK``, at most 32), and the count of its launches since the last
    reset (only a kernel launch adds to it).

    A role of K1 or K4 also carries the operands' stored dtype (``DTYPE``)
    and its math mode (``EXACT``); the exact f32 role is the base of its
    variants, and :meth:`variant` finds the one for a dtype and a mode."""

    def __init__(self, name: str, replaces: str, source: str = SOURCE,
                 chunk: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, exact: bool = True):
        self.NAME = name
        self.REPLACES = replaces
        self.SOURCE = source
        self.CHUNK = chunk
        self.DTYPE = dtype
        self.EXACT = exact
        self.launches = 0
        self.base = self
        self._variants = {(dtype, exact): self}

    def variant(self, dtype: torch.dtype, exact: bool) -> "Role":
        """The variant of this role for operands stored as ``dtype`` in the
        math mode ``exact``."""
        try:
            return self.base._variants[(dtype, bool(exact))]
        except KeyError:
            raise TypeError(f"{self.base.NAME} has no variant for {dtype} "
                            f"operands") from None

    def __repr__(self):
        return f"Role({self.NAME})"


# the fast and bf16 variants beside each exact f32 role: the suffix of
# their names, the stored dtype and the math mode
VARIANTS = (("f32fast", torch.float32, False),
            ("bf16", torch.bfloat16, True),
            ("bf16fast", torch.bfloat16, False))


def add_variants(roles, variants=VARIANTS) -> Tuple[Role, ...]:
    """Makes the ``variants`` (by default the three other variants) of
    each exact f32 role in ``roles``, named with their suffix in place of
    ``_f32``, and returns them, role by role."""
    made = []
    for base in roles:
        for suffix, dtype, exact in variants:
            mode = "exact" if exact else "fast (exact=False)"
            role = Role(base.NAME.replace("_f32", f"_{suffix}"),
                        f"{base.REPLACES}, {mode}, "
                        f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
                        f"operands", base.SOURCE, base.CHUNK, dtype, exact)
            role.base = base
            base._variants[(dtype, exact)] = role
            made.append(role)
    return tuple(made)


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
FAST_ROLES = add_variants(ROLES)

# which operand (0: U, 1: V) is the cotangent g, always f32, in each role
_GRAD_OPERAND = {FWD: None, DX: 0, DA: 1}


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16, ties to even, kept as f32: the
    rounding of the fast mode, as ``astype(jnp.bfloat16)`` and
    ``__float2bfloat16_rn`` round."""
    return x.to(torch.bfloat16).to(torch.float32)


def contract_plain(U: torch.Tensor, V: torch.Tensor, tuv: torch.Tensor,
                   out_rows: int, exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of every role and variant: gather,
    multiply, sum into f32 rows, ``out[t] += L[u] * R[v]``.  The operands
    are widened to f32 (exactly, from bf16); with ``exact=False`` each is
    rounded to bf16 and so is each product, before the f32 sum."""
    t, u, v = tuv.long()
    L, R = U.float(), V.float()
    if not exact:
        L, R = to_bf16(L), to_bf16(R)
    terms = L[u] * R[v]
    if not exact:
        terms = to_bf16(terms)
    out = torch.zeros(out_rows, U.shape[1], dtype=torch.float32,
                      device=U.device)
    return out.index_add_(0, t, terms)


def _lib() -> ctypes.CDLL:
    lib = _build.load("spspmm_sum")
    for role in ROLES + FAST_ROLES:
        fn = getattr(lib, role.NAME)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def operands_dtype(name: str, grad: Optional[int], L: torch.Tensor,
                   R: torch.Tensor, names: str = "UV") -> torch.dtype:
    """The stored dtype that picks the variant of the role ``name`` on the
    operands ``L`` and ``R`` (called ``names`` in errors): both operands'
    one dtype where neither is a cotangent (``grad`` None, a forward);
    else that of the operand beside the cotangent (``grad``: 0 for ``L``,
    1 for ``R``), which must be f32.  Raises on anything else (mixed
    operands, a dtype with no variant)."""
    if grad is None:
        if L.dtype != R.dtype:
            raise TypeError(f"{name}: {names[0]} and {names[1]} must share "
                            f"one dtype, got {L.dtype} and {R.dtype}")
        dtype = L.dtype
    else:
        g, x = (L, R) if grad == 0 else (R, L)
        if g.dtype != torch.float32:
            raise TypeError(f"{name}: the cotangent {names[grad]} must be "
                            f"float32, got {g.dtype}")
        dtype = x.dtype
    if dtype not in STORED:
        raise TypeError(f"{names[0]} and {names[1]} must be float32 or "
                        f"bfloat16, got {L.dtype}, {R.dtype}")
    return dtype


def stored_dtype(role: Role, U: torch.Tensor, V: torch.Tensor) -> torch.dtype:
    """The stored dtype that picks ``role``'s variant (:func:`operands_dtype`
    with K1's cotangents: dX's ``U``, dA's ``V``)."""
    return operands_dtype(role.base.NAME, _GRAD_OPERAND[role.base], U, V)


def _check(U, V, tuv, rowptr):
    for name, t in (("U", U), ("V", V), ("tuv", tuv), ("rowptr", rowptr)):
        if t.device != U.device:
            raise ValueError(f"{name} is on {t.device}, U on {U.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
             tuv: torch.Tensor, rowptr: torch.Tensor,
             exact: bool = True) -> torch.Tensor:
    """One role of K1, ``out[t] = sum over (t, u, v) of U[u] * V[v]``, as
    an ``(out_rows, D)`` float32 tensor, ``out_rows = len(rowptr) - 1``,
    in the variant of ``role`` that the operands' dtype and ``exact``
    select (module docstring; :func:`stored_dtype`).

    ``tuv``: int32 ``(3, k)`` real triples sorted by ``t``; ``rowptr``:
    int32 row pointer of ``tuv[0]`` over the output rows.  Every index
    must be in range (checked on the host when the batch is built).
    Rows with no triples come out 0.
    """
    _check(U, V, tuv, rowptr)
    role = role.variant(stored_dtype(role, U, V), exact)
    out_rows = rowptr.shape[0] - 1
    D = U.shape[1]
    if U.device.type == "cpu":
        if int(rowptr[-1]) != tuv.shape[1]:
            raise ValueError("rowptr does not cover the triples")
        return contract_plain(U, V, tuv, out_rows, role.EXACT)
    if U.device.type != "cuda":
        raise ValueError(f"no kernel for device {U.device}")
    out = torch.empty(out_rows, D, dtype=torch.float32, device=U.device)
    if out_rows == 0:
        return out
    launch(role, _lib(), U.device, U.data_ptr(), V.data_ptr(),
           tuv[0].data_ptr(), tuv[1].data_ptr(), tuv[2].data_ptr(),
           rowptr.data_ptr(), out.data_ptr(), tuv.shape[1], role.CHUNK,
           out_rows, D)
    return out


def launch(role: Role, lib: ctypes.CDLL, device: torch.device,
           *args) -> None:
    """Calls ``role``'s own entry point in ``lib`` with ``args`` and the
    current stream of ``device``, and counts the launch; raises where the
    entry point reports a CUDA error (a launch that never ran)."""
    with torch.cuda.device(device):
        rc = getattr(lib, role.NAME)(*args,
                                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role.NAME} launch failed: CUDA error {rc}")
    role.launches += 1


def spspmm_sum(U: torch.Tensor, V: torch.Tensor, acd: torch.Tensor,
               rowptr: torch.Tensor) -> torch.Tensor:
    """The forward role: ``out[a] = sum over (a, c, d) of U[c] * V[d]``."""
    return contract(FWD, U, V, acd, rowptr)


# the backward roles' triples and row pointers: (cad, rowptr_dx, dca,
# rowptr_da), as ``hodata.loader.add_rowptr(..., backward=True)`` builds
BackwardOrders = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]


class SpspmmSum(torch.autograd.Function):
    """Differentiable K1: ``SpspmmSum.apply(U, V, acd, rowptr, bwd,
    exact)``, ``exact`` True unless given.

    Forward: the forward role, an f32 result.  Backward: the dX role gives
    ``grad_U`` and the dA role gives ``grad_V``, each run only where
    ``ctx.needs_input_grad`` asks for it, in the same math mode, and each
    returned in its operand's dtype (the counterpart of
    ``fused_spspmm_strip``'s ``_bwd_rule``).  ``bwd`` is the backward
    orders (:data:`BackwardOrders`); without them the forward runs, and a
    backward through it raises.  The incoming gradient is taken in f32;
    in fast mode the dX and dA roles round it to bf16 as they read it.
    """

    @staticmethod
    def forward(ctx, U, V, acd, rowptr, bwd: Optional[BackwardOrders],
                exact: bool = True):
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
        ctx.exact = exact
        return contract(FWD, U, V, acd, rowptr, exact)

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
        dU = contract(DX, g, V, cad, rp_dx, ctx.exact).to(U.dtype) \
            if ctx.needs_input_grad[0] else None
        dV = contract(DA, U, g, dca, rp_da, ctx.exact).to(V.dtype) \
            if ctx.needs_input_grad[1] else None
        return dU, dV, None, None, None, None
