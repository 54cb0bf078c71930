"""The fast numerics mode of the port against the JAX package, on the CPU:
K1's three roles and K4's four in their fast and bf16 variants (the
plain versions here, on the host orders the card's kernels read) against
the TPU kernels in interpret mode, the layers and a 2x128 model in fast
mode and with bf16 compute, and a ten-step fast-mode NGNN-SS trajectory
at width 128.

JAX runs its kernels, and so its fast math, only on plans built by the
loader and at a width that is a multiple of 128; anywhere else it runs the
exact XLA path, and a comparison in fast mode would prove nothing.  So
every comparison here is at D = 128 on built plans, and checks that the
plans are there.  ``set_fused_math`` is global in both packages: every
test that changes it restores it in the ``fast`` fixture's ``finally``.

Every input comes from a numpy seed; each test states its tolerance."""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.backend.indexing import PAD_INDEX
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.kernels.fused_spspmm import get_fused_math as jx_get_fused_math
from pygho_tpu.kernels.fused_spspmm import set_fused_math as jx_set_fused_math
from pygho_tpu.kernels.strip_attention import (_pad_to,
                                               build_attention_strip_plans,
                                               fused_attention_strip,
                                               strip_attention_role)
from pygho_tpu.kernels.strip_spspmm import (_pad_rows,
                                            autotune_strip_geoms,
                                            build_spspmm_strip_plans,
                                            strip_contract)
from pygho_tpu.models import make_sp_model as jx_make_sp_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch import kernels as pt_kernels
from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.hodata.loader import add_rowptr, backward_orders
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn.utils import MLP
from pygho_tpu_torch.kernels import segment_attention as k4
from pygho_tpu_torch.kernels import spspmm_sum as k1
from pygho_tpu_torch.models import make_sp_model, training
from pygho_tpu_torch.weights import load_jax_params

KEY = "X___X___1___A___0"
D = 128
# K1 against the TPU kernel: both sides make the same roundings, so they
# differ only in the order of the f32 sums: at most 1e-5 of each row's sum
# of |terms| (k terms summed in f32 are off by at most about k * 2^-24 of
# that sum; the rows here hold at most a few dozen terms)
K1_RTOL = 1e-5
# K4's gradient roles against the TPU kernel's on the same inputs and the
# same shift (0): the same roundings, f32 sums in another order, as K1;
# but e comes from exp, whose last bits differ between XLA's and
# PyTorch's (and between PyTorch's vector and scalar code), and a term
# that lies within those bits of a bf16 rounding boundary rounds the other
# way on one side: one bf16 step of one term, at most 2^-7 of it and so of
# the sum of |terms|.  So every output is held to 2^-7 of its sum of |terms|, and all
# but at most K4_FLIPS of them to K4_RTOL (assert_k4_close)
K4_RTOL = 1e-5
K4_FLIPS = 0.01
# K4 through its Function against fused_attention_strip: the shifts differ
# (the port's exact row maximum, the JAX kernel's bound |a2| max|a1|
# max|aA|) by a factor of the row that is not a power of two, so e, den,
# gZ, goZ and every message are rounded to bf16 at other points of the
# bf16 grid on the two sides: about six roundings, each of at most 2^-8 of
# its value and independent of the other side's, reach an output on each
# side; their errors add like a random walk, about sqrt(12) * 2^-8 = 1.4%
# of the output's scale (k4_scales); 2^-5 allows twice that, since that
# scale is taken from the exact-mode values, which the fast mode's rounded
# operands move by up to a few per cent through exp
K4_FN_RTOL = 2 ** -5
# the layers and models in fast mode, f32 values: the same roundings on
# both sides, but an operand whose f32 value differs in its last bits
# between the two (another order of a sum in the MLP's norm, another exp
# in its activation) may round to bf16 the other way, which moves a term
# by one bf16 step, up to 2^-7 of itself: all entries within LAYER_RTOL of
# the largest (a term is at most a tenth of it here), and
# all but LAYER_FLIPS of them within K1_RTOL of it
LAYER_RTOL = 1e-3
LAYER_FLIPS = 0.01
# with bf16 compute (dtype=bf16) every layer's output is stored in bf16 and
# the two packages round inside the MLP at other points (XLA fuses the
# bias add and the activation, PyTorch rounds after each): two bf16 steps
# of the largest entry of a layer's output or gradient (one step is 2^-8
# to 2^-7 of it)
BF16_RTOL = 2 ** -6
# predictions of order 1 of a 2x128 model with bf16 compute: every layer,
# the pooling and the head round to bf16 (2^-7 at 1) and the roundings
# fall at other points on the two sides: eight bf16 steps at 1
BF16_PRED_TOL = 2 ** -4
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}


@pytest.fixture()
def fast():
    """Fast math in both packages for the test, the previous modes
    restored after it, whatever happens."""
    was = jx_get_fused_math(), pt_kernels.get_fused_math()
    jx_set_fused_math(False)
    pt_kernels.set_fused_math(False)
    try:
        yield
    finally:
        jx_set_fused_math(was[0])
        pt_kernels.set_fused_math(was[1])


def test_fused_math_defaults_to_exact():
    """Same names and default as the JAX package, and a set that
    sticks."""
    assert pt_kernels.get_fused_math() is True
    assert jx_get_fused_math() is True
    try:
        pt_kernels.set_fused_math(0)
        assert pt_kernels.get_fused_math() is False
    finally:
        pt_kernels.set_fused_math(True)


# ---------------------------------------------------------------------------
# K1's roles against the TPU kernel
# ---------------------------------------------------------------------------


def _k1_case(rng):
    """A 4-graph batch, the JAX loader's strip plans over it, the port's
    backward orders, and operands X, A (zero padded rows) and g."""
    pre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=4)]
    batch = jx_collate_sparse(datas, [KEY], [""], 4)
    acd = batch[f"{KEY}___acd"]
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    geoms = autotune_strip_geoms(acd, nt, ne, nt, D=D, probe=False)
    plans = dict(zip(("fwd", "dx", "da"),
                     build_spspmm_strip_plans(acd, nt, ne, nt, geoms)))
    pb = copy.deepcopy(batch)
    add_rowptr(pb, [KEY], backward=True)
    orders = {r: (torch.from_numpy(pb[f"{KEY}___acd{s}"]),
                  torch.from_numpy(pb[f"{KEY}___rowptr{s}"]))
              for r, s in (("fwd", ""), ("dx", "_dx"), ("da", "_da"))}

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return x

    X = operand(nt, int(batch["num_tuples"]))
    A = operand(ne, int(batch["num_edges"]))
    g = operand(nt, int(batch["num_tuples"]))
    return plans, orders, X, A, g


# each role's operands (L, R), with the one that is the cotangent (always
# f32) named g
K1_OPERANDS = {"fwd": ("X", "A"), "dx": ("g", "A"), "da": ("X", "g")}
K1_ROLES = {"fwd": k1.FWD, "dx": k1.DX, "da": k1.DA}


def _k1_both(role, plans, orders, ops, dtype, exact):
    """One role on the JAX kernel (interpret mode) and on the port, and
    the role's sum of |terms| per output, all as numpy f32."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    L, R = (ops[n] for n in K1_OPERANDS[role])
    jL, jR = (jnp.asarray(ops[n], jnp.float32 if n == "g" else jdt)
              for n in K1_OPERANDS[role])
    plan = plans[role]
    tuv, rowptr = orders[role]
    rows = rowptr.shape[0] - 1
    ref = np.asarray(strip_contract(_pad_rows(jL, plan.u_rows),
                                    _pad_rows(jR, plan.v_rows), plan,
                                    interpret=True, exact=exact))[:rows]
    tL, tR = (torch.from_numpy(ops[n]).to(torch.float32 if n == "g"
                                           else dtype)
              for n in K1_OPERANDS[role])
    out = k1.contract(K1_ROLES[role], tL, tR, tuv, rowptr, exact)
    mag = k1.contract(K1_ROLES[role], tL.abs(), tR.abs(), tuv, rowptr, exact)
    assert out.dtype == torch.float32
    return out.numpy(), ref, mag.numpy(), (L, R, tuv, rows)


def _ratio(out, ref, mag):
    """The largest difference over its allowance K1_RTOL * sum |terms|."""
    return float((np.abs(out - ref) / np.maximum(K1_RTOL * mag,
                                                 1e-30)).max())


@pytest.mark.parametrize("role", ["fwd", "dx", "da"])
@pytest.mark.parametrize("dtype,exact", [(torch.float32, False),
                                         (torch.bfloat16, True),
                                         (torch.bfloat16, False)],
                         ids=["f32fast", "bf16", "bf16fast"])
def test_k1_role_matches_the_tpu_kernel(rng, role, dtype, exact):
    """Each of K1's roles in each new variant against the JAX kernel's
    role (``strip_contract``, the contraction behind
    ``fused_spspmm_strip``, in interpret mode) on the loader's plans of a
    4-graph batch: within K1_RTOL of each row's sum of |terms|."""
    plans, orders, X, A, g = _k1_case(rng)
    out, ref, mag, _ = _k1_both(role, plans, orders,
                                {"X": X, "A": A, "g": g}, dtype, exact)
    assert np.abs(ref).max() > 1                  # not vacuous
    assert _ratio(out, ref, mag) <= 1.0


def test_k1_tolerance_tells_the_roundings_apart(rng):
    """The control: at K1_RTOL the test sees a missing rounding.  The
    exact forward and a forward that rounds the operands but not their
    products both lie far outside the allowance around the JAX fast
    forward; the port's fast forward lies inside it."""
    plans, orders, X, A, g = _k1_case(rng)
    ops = {"X": X, "A": A, "g": g}
    out, ref, mag, (L, R, tuv, rows) = _k1_both("fwd", plans, orders, ops,
                                                torch.float32, False)
    assert _ratio(out, ref, mag) <= 1.0
    exact = k1.contract_plain(torch.from_numpy(L), torch.from_numpy(R),
                              tuv, rows).numpy()
    t, u, v = tuv.long()
    Lb, Rb = (k1.to_bf16(torch.from_numpy(x)) for x in (L, R))
    once = torch.zeros(rows, D).index_add_(0, t, Lb[u] * Rb[v]).numpy()
    assert _ratio(exact, ref, mag) > 20
    assert _ratio(once, ref, mag) > 20


def test_k1_plain_rounds_where_the_kernel_does(rng):
    """``contract_plain``'s fast variant against a float64 loop that rounds
    each operand and each product to bf16 (numpy, through
    ``torch.bfloat16``): the same terms, so within K1_RTOL; and the
    gradient roles take the cotangent in f32 beside bf16 operands."""
    out_rows, u_rows, v_rows = 40, 30, 20
    a = np.sort(np.concatenate([np.full(200, 7),
                                rng.integers(0, 30, 60)]))
    tuv = np.stack([a, rng.integers(0, u_rows, a.size),
                    rng.integers(0, v_rows, a.size)]).astype(np.int32)
    U = rng.normal(size=(u_rows, D)).astype(np.float32)
    V = rng.normal(size=(v_rows, D)).astype(np.float32)

    def bf(x):
        return torch.from_numpy(np.asarray(x, np.float32)) \
            .to(torch.bfloat16).double().numpy()

    ref = np.zeros((out_rows, D))
    mag = np.zeros((out_rows, D))
    for t, c, d in tuv.T:
        term = bf(bf(U[c]) * bf(V[d]))
        ref[t] += term
        mag[t] += np.abs(term)
    out = k1.contract_plain(torch.from_numpy(U), torch.from_numpy(V),
                            torch.from_numpy(tuv), out_rows, exact=False)
    assert _ratio(out.numpy(), ref, mag) <= 1.0
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(a, minlength=out_rows))])
        .astype(np.int32))
    for exact in (True, False):
        got = k1.contract(k1.FWD, torch.from_numpy(U).bfloat16(),
                          torch.from_numpy(V).bfloat16(),
                          torch.from_numpy(tuv), rowptr, exact)
        want = k1.contract_plain(torch.from_numpy(U).bfloat16().float(),
                                 torch.from_numpy(V).bfloat16().float(),
                                 torch.from_numpy(tuv), out_rows, exact)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K4's roles against the TPU kernel
# ---------------------------------------------------------------------------


def _k4_case(rng, x_rows=300, e_rows=200, K=900):
    """``tests/test_kernels.py``'s attention case: K triples sorted by a,
    the single-launch strip plans over them (padded to 1,024), the port's
    row pointer and backward orders, the four operands ``(a1, a3, aA,
    a2)`` and a cotangent."""
    a = np.sort(rng.integers(0, x_rows, K))
    acd = np.stack([a, rng.integers(0, x_rows, K),
                    rng.integers(0, e_rows, K)])
    padded = np.full((3, 1024), PAD_INDEX, np.int64)
    padded[:, :K] = acd
    geoms = {r: (64, 128, 256, 128, 128, 1) for r in ("fwd", "dx", "da")}
    plans = build_attention_strip_plans(padded, x_rows, e_rows, geoms)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(a, minlength=x_rows))])
    orders = backward_orders(acd, x_rows, e_rows)
    port = {"fwd": (torch.from_numpy(acd.astype(np.int32)),
                    torch.from_numpy(rowptr.astype(np.int32)))}
    port.update({r: tuple(torch.from_numpy(x) for x in orders[r])
                 for r in ("dx", "da")})
    ops = tuple(rng.standard_normal((n, D)).astype(np.float32)
                for n in (x_rows, x_rows, e_rows, x_rows))
    w = rng.standard_normal((x_rows, D)).astype(np.float32)
    return acd, plans, port, ops, w


def _bf16_valued(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _jax_grad_roles(plans, ops, gZ, goZ, exact):
    """The JAX kernel's dw, dc and dv roles (interpret mode), called as
    ``_att_bwd`` calls them, with the shift bound ``m`` 0."""
    fwdp, dxp, dap = plans
    j = [jnp.asarray(x) for x in ops + (gZ, goZ)]
    rows2 = max(fwdp.out_rows, dxp.u_rows, dap.v_rows)
    rows13 = max(fwdp.u_rows, dxp.out_rows, dap.u_rows)
    T2 = tuple(_pad_to(x, rows2) for x in (j[3], j[4], j[5]))
    U13 = tuple(_pad_to(x, rows13) for x in (j[0], j[1]))
    V = (_pad_to(j[2], max(fwdp.v_rows, dxp.v_rows, dap.out_rows)),)
    m = jnp.zeros((1, D), jnp.float32)
    return {"dw": np.asarray(strip_attention_role("dw", U13, V, T2, m, fwdp,
                                                  True, exact)),
            "dc": np.asarray(strip_attention_role("dc", T2, V, U13, m, dxp,
                                                  True, exact)),
            "dv": np.asarray(strip_attention_role("dv", U13, T2, V, m, dap,
                                                  True, exact))}


def assert_k4_close(x, ref, terms):
    """Every entry within 2^-7 of its sum of |terms| (one flipped bf16
    rounding of one term), and all but a share K4_FLIPS within K4_RTOL of
    it."""
    diff = np.abs(x - ref)
    assert (diff <= 2 ** -7 * terms + 1e-30).all()
    assert (diff > K4_RTOL * terms + 1e-30).mean() <= K4_FLIPS


def k4_role_terms(role, ops, tuv, rows, M, gZ, goZ):
    """Each output of one K4 gradient role's sum of |terms| (f32, exact
    mode), the scale of its rounding: |ds| e (|a3[c]| |gZ[a]| +
    |goZ[a]|) times the role's two factors, and dc's sum of e |gZ[a]|."""
    a1, a3, aA, a2 = (torch.from_numpy(x).float() for x in ops)
    idx = tuv.long()
    a, c, d = (idx[i] for i in k4.ACD_POSITIONS[role])

    def ssum(x):
        return torch.zeros(rows, D).index_add_(0, idx[0], x).numpy()

    e = torch.exp((a1[c] * aA[d]) * a2[a] - M[a])
    ads = e * (a3[c].abs() * gZ[a].abs() + goZ[a].abs())
    if role is k4.DW:
        return (ssum(ads * a1[c].abs() * aA[d].abs()),)
    if role is k4.DC:
        return (ssum(ads * aA[d].abs() * a2[a].abs()),
                ssum(e * gZ[a].abs()))
    return (ssum(ads * a1[c].abs() * a2[a].abs()),)


K4_VARIANTS = [(torch.float32, False), (torch.bfloat16, True),
               (torch.bfloat16, False)]
K4_IDS = ["f32fast", "bf16", "bf16fast"]


@pytest.mark.parametrize("dtype,exact", K4_VARIANTS, ids=K4_IDS)
def test_k4_gradient_roles_match_the_tpu_kernel(rng, dtype, exact):
    """K4's dw, dc and dv roles in each new variant against the JAX
    kernel's (``strip_attention_role`` in interpret mode, as ``_att_bwd``
    calls it) on the same a1, a3, aA, a2, gZ and goZ, with the shift 0 on
    both sides (the port's roles take ``M`` as an input, the JAX kernel's
    its bound ``m``): within K4_RTOL of each output's sum of |terms|.  A
    bf16 operand reaches the JAX roles as f32 holding its bf16 value, as
    ``_att_bwd`` casts it."""
    _, plans, port, ops, w = _k4_case(rng)
    x_rows, e_rows = ops[0].shape[0], ops[2].shape[0]
    if dtype == torch.bfloat16:
        ops = tuple(_bf16_valued(x) for x in ops)
    gZ = rng.standard_normal((x_rows, D)).astype(np.float32)
    goZ = rng.standard_normal((x_rows, D)).astype(np.float32)
    ref = _jax_grad_roles(plans, ops, gZ, goZ, exact)
    t_ops = [torch.from_numpy(x).to(dtype) for x in ops]
    grads = (torch.zeros(x_rows, D), torch.from_numpy(gZ),
             torch.from_numpy(goZ))
    for role, key in ((k4.DW, "fwd"), (k4.DC, "dx"), (k4.DV, "da")):
        got = k4.attend(role, *t_ops, *port[key], *grads, exact)
        mag = k4_role_terms(role, ops, port[key][0], got[0].shape[0],
                            *grads)
        want = np.split(ref[role.NAME.split("_")[2]][:got[0].shape[0]],
                        len(got), axis=1)
        for x, r, mg in zip(got, want, mag):
            assert x.dtype == torch.float32
            assert np.abs(r).max() > 0.1                 # not vacuous
            assert_k4_close(x.numpy(), r, mg)


def test_k4_tolerance_tells_fast_from_exact(rng):
    """The control for K4: on the same inputs, the fast dw role passes
    :func:`assert_k4_close` around the JAX kernel's fast dw role, and the
    exact one lies outside K4_RTOL on far more than the K4_FLIPS share of
    its outputs."""
    _, plans, port, ops, w = _k4_case(rng)
    x_rows = ops[0].shape[0]
    gZ = rng.standard_normal((x_rows, D)).astype(np.float32)
    goZ = rng.standard_normal((x_rows, D)).astype(np.float32)
    ref = _jax_grad_roles(plans, ops, gZ, goZ, False)["dw"][:x_rows]
    t_ops = [torch.from_numpy(x) for x in ops]
    grads = (torch.zeros(x_rows, D), torch.from_numpy(gZ),
             torch.from_numpy(goZ))
    mag = k4_role_terms(k4.DW, ops, port["fwd"][0], x_rows, *grads)[0]
    fast = k4.attend(k4.DW, *t_ops, *port["fwd"], *grads, False)[0]
    assert_k4_close(fast.numpy(), ref, mag)
    exact = k4.attend(k4.DW, *t_ops, *port["fwd"], *grads, True)[0]
    outside = np.abs(exact.numpy() - ref) > K4_RTOL * mag
    assert outside.mean() > 20 * K4_FLIPS


def k4_scales(acd, ops, w):
    """The scale of each output of K4's forward and of each gradient, from
    the exact-mode values: out's sum of alpha |a3| (S), and each gradient's
    sum over its triples of |terms| with |ds| taken as e |gZ| (|a3| + S),
    which covers the cancellation in out and in a3 gZ - goZ."""
    a1, a3, aA, a2 = (torch.from_numpy(x).float() for x in ops)
    x_rows, e_rows = a1.shape[0], aA.shape[0]
    tuv = torch.from_numpy(acd.astype(np.int32))
    a, c, d = tuv.long()
    out, den, M = k4.attention_plain(k4.FWD, a1, a3, aA, a2, tuv, x_rows)
    S = k4.attention_plain(k4.FWD, a1, a3.abs(), aA, a2, tuv, x_rows)[0]
    gZ, _ = k4.softmax_cotangents(torch.from_numpy(w), out, den)
    e = torch.exp((a1[c] * aA[d]) * a2[a] - M[a])
    ads = e * gZ[a].abs() * (a3[c].abs() + S[a])

    def ssum(x, t, n):
        return torch.zeros(n, D).index_add_(0, t, x).numpy()

    return [S.numpy(),
            ssum(ads * aA[d].abs() * a2[a].abs(), c, x_rows),
            ssum(e * gZ[a].abs(), c, x_rows),
            ssum(ads * a1[c].abs() * a2[a].abs(), d, e_rows),
            ssum(ads * a1[c].abs() * aA[d].abs(), a, x_rows)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_function_matches_the_tpu_kernel(rng, dtype):
    """``SegmentAttention`` in fast mode, forward and all four gradients,
    against ``fused_attention_strip(..., exact=False)`` in interpret mode
    and its VJP, on f32 and on bf16 operands (gradients in the operands'
    dtype on both sides): within K4_FN_RTOL of each output's scale."""
    acd, plans, port, ops, w = _k4_case(rng)
    x_rows = ops[0].shape[0]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out, vjp = jax.vjp(
        lambda *o: fused_attention_strip(*o, *plans, None, True, False)[
            :x_rows], *(jnp.asarray(x, jdt) for x in ops))
    refs = [np.asarray(out)] + [np.asarray(g, np.float32)
                                for g in vjp(jnp.asarray(w))]
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in ops]
    got = k4.SegmentAttention.apply(*ts, *port["fwd"],
                                    port["dx"] + port["da"], False)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == torch.float32
    assert all(t.grad.dtype == dtype for t in ts)
    outs = [got.detach().numpy()] + [t.grad.float().numpy() for t in ts]
    for name, x, r, sc in zip(("out", "a1", "a3", "aA", "a2"), outs, refs,
                              k4_scales(acd, ops, w)):
        assert np.abs(r).max() > 0.1, name              # not vacuous
        assert (np.abs(x - r) <= K4_FN_RTOL * sc + 1e-30).all(), name


# ---------------------------------------------------------------------------
# the layers and the model
# ---------------------------------------------------------------------------


def jax_params(module):
    """The JAX module's state flattened to numpy arrays by path."""
    return {path: np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(module))}


def _port_name(path):
    dotted = ".".join(str(p) for p in path)
    prefix, _, leaf = dotted.rpartition(".")
    if leaf in ("kernel", "embedding"):
        return f"{prefix}.weight", leaf == "kernel"
    return dotted, False


def bn_fed_biases(model):
    """Names of the Linear biases whose gradient is 0 in exact arithmetic
    in training mode (they feed a BatchNorm, or, NGAT's ``att3`` bias, the
    softmax adds them whole to a row that a norm centres again), and of
    the running means they shift: their gradients are rounding noise."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, MLP):
            for i in range(len(mod.hid_lins)):
                names |= {f"{prefix}.hid_lins.{i}.bias",
                          f"{prefix}.hid_norms.{i}.mean"}
            if mod.tail_lin is not None and mod.tailact:
                names |= {f"{prefix}.tail_lin.bias",
                          f"{prefix}.tail_norm.mean"}
        if isinstance(mod, pt_conv.NGATConv):
            names.add(f"{prefix}.att3.bias".lstrip("."))
    return names


def maxrel(x, ref):
    """Largest difference over the largest magnitude of the reference."""
    x, ref = np.asarray(x, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(x - ref).max()) / (float(np.abs(ref).max()) + 1e-9)


def assert_layer_close(x, ref, bf16):
    """BF16_RTOL of the largest entry with bf16 compute; else LAYER_RTOL
    of it everywhere and K1_RTOL of it on all but LAYER_FLIPS."""
    x, ref = np.asarray(x, np.float32), np.asarray(ref, np.float32)
    top = float(np.abs(ref).max())
    assert top > 1e-3                                    # not vacuous
    if bf16:
        assert maxrel(x, ref) <= BF16_RTOL
        return
    diff = np.abs(x - ref)
    assert diff.max() <= LAYER_RTOL * top
    assert (diff > K1_RTOL * top).mean() <= LAYER_FLIPS


CONV_VARIANTS = [("NGNN", False), ("NGNN", True), ("NGAT", False),
                 ("NGAT", True)]


@pytest.mark.parametrize("conv,bf16", CONV_VARIANTS,
                         ids=[f"{c}-{'bf16' if b else 'f32'}"
                              for c, b in CONV_VARIANTS])
def test_conv_matches_jax_in_fast_mode(rng, fast, conv, bf16):
    """``NGNNConv`` and ``NGATConv`` at D = 128 in training mode, fast
    mode, on f32 values (MLP in f32) and with bf16 compute (bf16 values,
    MLP in bf16), against the JAX layer on its kernel path (the loader's
    spspmm plans for NGNN, its single-launch attention plans for NGAT),
    weights carried across: the output (in the input's dtype on both
    sides) and the gradients of the inputs and of every parameter but
    those of :func:`bn_fed_biases`.  Tolerances: assert_layer_close for
    NGNN; for NGAT, whose attention runs in f32 fast math with either
    compute dtype, K4's Function's (K4_FN_RTOL of the largest entry: the
    shifts differ)."""
    plans = (dict(build_plans=True, plan_dim=D) if conv == "NGNN"
             else dict(attention_plans=True, plan_dim=D))
    jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], [KEY])
    jb = next(iter(JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
        "val", n_graphs=4)], 4, [KEY], device_put=False, prefetch=0,
        **plans)))
    assert f"{KEY}___{'plan' if conv == 'NGNN' else 'attplan1'}" in jb
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    pb = next(iter(SpDataloader([pre(g) for g in synthetic_zinc(
        "val", n_graphs=4)], 4, [KEY], backward=True)))
    nt, ne = int(jb["num_tuples"]), int(jb["num_edges"])
    U = np.zeros((jb["tupleid"].shape[1], D), np.float32)
    V = np.zeros((jb["edge_index"].shape[1], D), np.float32)
    U[:nt] = rng.normal(size=(nt, D))
    V[:ne] = rng.normal(size=(ne, D))
    W = rng.normal(size=U.shape).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    mlp = {**MLPD, "numlayer": 1, "tailact": True}
    jc = getattr(jx_conv, f"{conv}Conv")(
        D, D, "sum", "SS", dict(mlp, **({"dtype": jdt} if bf16 else {})),
        rngs=nnx.Rngs(2))
    pc = getattr(pt_conv, f"{conv}Conv")(
        D, D, "sum", "SS", dict(mlp, **({"dtype": tdt} if bf16 else {})),
        generator=torch.Generator().manual_seed(0))
    load_jax_params(pc, jax_params(jc))
    jc.train()
    pc.train()

    jd = jx_to_dict(jb)
    graphdef, state = nnx.split(jc)

    def jloss(state, u, v):
        X = jd["X"].__class__(jd["X"].indices, u.astype(jdt), jd["X"].nnz,
                              jd["X"].sparse_shape)
        A = jd["A"].__class__(jd["A"].indices, v.astype(jdt), jd["A"].nnz,
                              jd["A"].sparse_shape)
        out = nnx.merge(graphdef, state)(A, X, jd).values
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(W)), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        state, jnp.asarray(U), jnp.asarray(V))

    pd = batch_to_sparse_dict(pb, ("",), torch.device("cpu"))
    Ut = torch.from_numpy(U).requires_grad_()
    Vt = torch.from_numpy(V).requires_grad_()
    pX = SparseTensor(pd["X"].indices, Ut.to(tdt), pd["X"].nnz,
                      pd["X"].sparse_shape)
    pA = SparseTensor(pd["A"].indices, Vt.to(tdt), pd["A"].nnz,
                      pd["A"].sparse_shape)
    out = pc(pA, pX, pd).values
    (out.float() * torch.from_numpy(W)).sum().backward()
    assert out.dtype == tdt and ref.dtype == jdt
    loose = conv == "NGAT"

    def close(x, r):
        if loose:
            assert maxrel(x, r) <= K4_FN_RTOL
        else:
            assert_layer_close(x, r, bf16)

    close(out.detach().float().numpy(), ref)
    assert np.all(out.detach().float().numpy()[nt:] == 0)
    close(Ut.grad.numpy(), jg[1])
    close(Vt.grad.numpy(), jg[2])
    params = dict(pc.named_parameters())
    noisy = bn_fed_biases(pc)
    for path, g in nnx.to_flat_state(jg[0]):
        name, transpose = _port_name(path)
        if name not in params:             # BatchNorm statistics
            continue
        g = np.asarray(g.get_value(), np.float32)
        got = params.pop(name).grad.numpy()
        if name not in noisy:
            close(got, g.T if transpose else g)
    assert not params


MODEL_VARIANTS = [("NGNN", None, False), ("NGNN", "bf16", True),
                  ("NGNN", "bf16", False), ("NGAT", None, False),
                  ("NGAT", "bf16", False)]


@pytest.mark.parametrize("conv,dtype,exact", MODEL_VARIANTS,
                         ids=[f"{c}-{d or 'f32'}-{'exact' if e else 'fast'}"
                              for c, d, e in MODEL_VARIANTS])
def test_sp_model_forward_matches_jax(conv, dtype, exact):
    """``SpModel`` 2x128 in training mode, one forward on an 8-graph batch,
    against the JAX model on its kernel path, from the JAX model's weights
    (with ``dtype=bf16`` on both sides where given: the JAX bf16 model's
    f32 parameters give the port's bf16 model).  Tolerance on predictions
    of order 1: 1e-4 abs in f32 for NGNN (the same arithmetic but for the
    order of the sums and rare flips of a bf16 rounding), K4_FN_RTOL / 2
    for NGAT in f32 (the shifts differ), BF16_PRED_TOL with bf16
    compute."""
    was = jx_get_fused_math(), pt_kernels.get_fused_math()
    jx_set_fused_math(exact)
    pt_kernels.set_fused_math(exact)
    try:
        jm = jx_make_sp_model(conv, num_layer=2, hiddim=D, mlp=dict(MLPD),
                              dtype=jnp.bfloat16 if dtype else None)
        keys = jx_keys(jm)
        pm = make_sp_model(conv, num_layer=2, hiddim=D, mlp=dict(MLPD),
                           device="cpu",
                           dtype=torch.bfloat16 if dtype else None)
        load_jax_params(pm, jax_params(jm))
        assert all(p.dtype == torch.float32 for p in pm.parameters())
        jm.train()
        pm.train()
        plans = (dict(build_plans=True, plan_dim=D) if conv == "NGNN"
                 else dict(attention_plans=True, plan_dim=D))
        jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
        jb = next(iter(JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
            "train", 8)], 8, keys, device_put=False, prefetch=0, **plans)))
        assert f"{KEY}___{'plan' if conv == 'NGNN' else 'attplan1'}" in jb
        ref = np.asarray(jm(jx_to_dict(jb)))
        pre = Sppretransform(partial(KhopSampler, hop=3), [""], keys)
        pb = next(iter(SpDataloader([pre(g) for g in synthetic_zinc(
            "train", 8)], 8, keys)))
        with torch.no_grad():
            pred = pm(batch_to_sparse_dict(pb, ("",), torch.device("cpu")))
    finally:
        jx_set_fused_math(was[0])
        pt_kernels.set_fused_math(was[1])
    assert pred.dtype == torch.float32 and pred.shape == ref.shape
    tol = (BF16_PRED_TOL if dtype else 1e-4 if conv == "NGNN"
           else K4_FN_RTOL / 2)
    assert np.abs(ref).max() > 0.1                      # not vacuous
    assert np.abs(pred.numpy() - ref).max() <= tol


def test_fast_training_trajectory_matches_jax(fast):
    """NGNN-SS, 2 layers x 128, 16 graphs in shuffled batches of 8, ten
    AdamW steps at lr 1e-3 in fast mode through the port's
    ``make_sparse_steps`` and the JAX package's (on the loader's spspmm
    plans, so the JAX kernel runs its fast math), from the same weights:
    parity bar 3 in the mode of the converged NGNN row.

    Step 1's loss: 1e-5 relative, the arithmetic of the first forward
    being the same on both sides (exact and fast math differ there by
    about 1e-3).  Later steps: 1e-2 relative.  From step 2 on the two
    sides train different parameters: a bf16 rounding that flips on one
    side moves its term by one bf16 step (up to 2^-7 of it), AdamW's
    normalised steps turn the gradient differences that follow into
    parameter differences of a fraction of lr each step, and the rounded
    terms pass them on: about 1.3 bf16 steps at 1 (2^-7 each) of the loss
    over ten steps.  Final
    parameters: within AdamW's bound of 1.25 lr a step on each side of
    the JAX package's, and none stuck."""
    L, H, G, BS, STEPS, LR = 2, D, 16, 8, 10, 1e-3
    jm = jx_make_sp_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD))
    keys = jx_keys(jm)
    start = jax_params(jm)
    jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    # workers=1: the JAX loader collates batches 2.. on a thread pool
    # that grows shared shape buckets as it goes
    # (pygho_tpu/hodata/loader.py:104-125), so its padding would depend
    # on thread timing; the port's loader collates in order
    jdl = JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
        "train", n_graphs=G)], BS, keys, shuffle=True, drop_last=True,
        seed=3, device_put=False, prefetch=0, workers=1, build_plans=True,
        plan_dim=H)
    jstep, _ = jx_training.make_sparse_steps()
    jopt = jx_training.make_optimizer(jm, LR)
    jm.train()

    pm = make_sp_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                       device="cpu")
    load_jax_params(pm, start)
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], keys)
    pdl = SpDataloader([pre(g) for g in synthetic_zinc("train",
                                                        n_graphs=G)],
                       BS, keys, shuffle=True, drop_last=True, seed=3,
                       backward=True)
    pstep, _ = training.make_sparse_steps()
    popt = training.make_optimizer(pm, LR)
    pm.train()

    def batches(dl):
        while True:
            yield from dl

    jl, pl = [], []
    for jb, pb, _ in zip(batches(jdl), batches(pdl), range(STEPS)):
        assert f"{KEY}___plan" in jb           # the kernel path, fast math
        jl.append(float(jstep(jm, jopt, jb)))
        pl.append(float(pstep(pm, popt, pb)))
    jl, pl = np.array(jl), np.array(pl)
    rel = np.abs(pl - jl) / np.abs(jl)
    assert rel[0] <= 1e-5 and np.all(rel <= 1e-2), (pl, jl)

    targets = dict(pm.named_parameters())
    adam_bound = 2 * STEPS * 1.25 * LR
    for path, ref in jax_params(jm).items():
        name, transpose = _port_name(path)
        if name not in targets:                 # BatchNorm statistics
            continue
        got = targets.pop(name).detach().numpy()
        ref = ref.T if transpose else ref
        first = start[path].T if transpose else start[path]
        assert not np.array_equal(got, first), f"{name} is stuck"
        assert np.abs(got - ref).max() <= adam_bound, name
    assert not targets
