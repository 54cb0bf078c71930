"""NGNN in the dense modes of the port against the JAX package, on the
CPU: K5's bf16 variant (``ChannelwiseBmm`` on bf16 operands, whose roles
run their plain version here) against the TPU kernel in interpret mode,
``mamamm`` in bf16, the fused route's triples (``spmamm_triples``),
``spmamm`` on each of its routes (densify, gather and fused, the fused one
against the v1 TPU kernel K2 in interpret mode on ``build_spmamm_plans``
chunk plans), the SD batches and loader, ``NGNNConv`` in DD and SD mode,
``MaModel("NGNN")`` in DD (f32 and bf16) and SD (both routes),
``MaPredictor(denseadj=False)`` and a five-step NGNN-DD trajectory.

Sizes are small: products at n <= 8, models of 2 layers x 32 on graphs
of ``synthetic_zinc`` (n padded to 32).  Every input comes from a numpy
seed; each test states its tolerance:

- ``CW_RTOL`` (1e-5) of each output's sum of |terms| where both sides sum
  the same f32 products in other orders;
- one bf16 step (``BF16_STEP``: at most 2^-7 of the value) more where an
  output is rounded to bf16 after such a sum, since an f32 difference in
  the last bits can flip the rounding;
- exact equality for host index arrays.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.backend.mamamm import mamamm as jx_mamamm
from pygho_tpu.backend.matensor import MaskedTensor as JxMaskedTensor
from pygho_tpu.backend.spmamm import set_dense_spmamm as jx_set_dense_spmamm
from pygho_tpu.backend.spmamm import spmamm as jx_spmamm
from pygho_tpu.backend.sptensor import SparseTensor as JxSparseTensor
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import MaDataloader as JxMaDataloader
from pygho_tpu.hodata.loader import Mapretransform as JxMapretransform
from pygho_tpu.hodata.ma_data import batch_to_dense_dict as jx_to_dict
from pygho_tpu.hodata.ma_data import collate_dense as jx_collate_dense
from pygho_tpu.hodata.ma_sampler import spdsampler as jx_spdsampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import utils as jx_utils
from pygho_tpu.honn.ma_operator import parse_spmamm_dims as jx_spmamm_dims
from pygho_tpu.kernels.channelwise_bmm import _cw_bmm_raw
from pygho_tpu.kernels.channelwise_bmm import channelwise_bmm as jx_cw
from pygho_tpu.kernels.fused_spmamm import build_spmamm_plans
from pygho_tpu.kernels.fused_spmamm import spmamm_triples as jx_triples
from pygho_tpu.kernels.fused_spspmm import set_fused_math as jx_set_fused_math
from pygho_tpu.models import MaPredictor as JxMaPredictor
from pygho_tpu.models import make_ma_model as jx_make_ma_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch import kernels as pt_kernels
from pygho_tpu_torch.backend.mamamm import mamamm
from pygho_tpu_torch.backend.matensor import MaskedTensor
from pygho_tpu_torch.backend.spmamm import set_dense_spmamm, spmamm
from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                    add_spmamm_triples, batch_to_dense_dict,
                                    collate_dense, spdsampler,
                                    synthetic_zinc)
from pygho_tpu_torch.hodata.loader import backward_orders, row_pointer
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn import parse_spmamm_dims
from pygho_tpu_torch.kernels import channelwise_bmm as k5
from pygho_tpu_torch.kernels import spspmm_sum as k1
from pygho_tpu_torch.kernels.fused_spmamm import spmamm_triples
from pygho_tpu_torch.models import (MaPredictor, make_dense_steps,
                                    make_ma_model, make_optimizer)
from pygho_tpu_torch.weights import load_jax_params

# the converged NGNN-dense configuration's MLPs (runs/converged/
# NGNN_dense.json, example/zinc_tpu.py:129)
MLPD = {"dp": 0.0, "norm": "bn", "act": "silu", "normparam": 0.194,
        "numlayer": 2, "tailact": True}
POOLS = dict(npool="sum", lpool="mean", outlayer=4)
HOP = 4
CW_RTOL = 1e-5
BF16_STEP = 2 ** -7
# predictions of a 2 x 32 model with bf16 compute, port against JAX on the
# CPU, relative to max(|prediction|, 1): each activation is rounded to
# bf16 (up to 2^-9 of it) after sums taken in other orders (K5's plain
# version sums k ascending in f32, JAX's CPU einsum in another order), so
# roundings flip by one bf16 step here and there, the flips travel through
# two layers, the pools and a bf16 head, and the prediction itself is a
# bf16 value (steps of 2^-7 to 2^-8 of it).  Over 20 seeds of this test's
# model each side lay up to 0.062 from the f32 model of the same weights
# and the two sides up to 0.055 (relative 0.055) from each other: 0.44 of
# this bound
BF16_PRED_RTOL = 2 ** -3
GEN = {"generator": torch.Generator().manual_seed(0)}


def _flat(jm):
    """The JAX module's state flattened to numpy arrays by path."""
    return {path: np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(jm))}


def _randomize_bn(module, rng):
    """Seeded, non-identity BatchNorm parameters and statistics."""
    for _, mod in nnx.iter_graph(module):
        if isinstance(mod, jx_utils.BatchNorm):
            d = mod.num_features
            mod.mean[...] = jnp.asarray(rng.normal(0, 0.5, d), jnp.float32)
            mod.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, d), jnp.float32)
            mod.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, d),
                                         jnp.float32)
            mod.bias[...] = jnp.asarray(rng.normal(0, 0.2, d), jnp.float32)


def _bf16(rng, shape):
    """Normal values rounded to bf16: numpy f32 and the torch bf16."""
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(torch.bfloat16)
    return t.float().numpy(), t


def _jbf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within(out, ref, mag, rounded=False):
    """``out`` within CW_RTOL of ``mag`` (each output's sum of |terms|)
    of ``ref``, and one bf16 step of ``ref`` more where ``rounded``."""
    allow = CW_RTOL * mag + (BF16_STEP * np.abs(ref) if rounded else 0.0)
    assert np.all(np.abs(out - ref) <= allow + 1e-30), \
        float(np.max(np.abs(out - ref) - allow))


# -- K5's bf16 variant ----------------------------------------------------

@pytest.mark.parametrize("role", ["fwd", "da", "dx"])
def test_cw_bmm_bf16_role_matches_the_tpu_kernel(rng, role):
    """Each bf16 role at (3, 8, 8, 32), its operands stored as the role
    stores them (the forward: A and X bf16; dA: g f32 and Xᵀ bf16; dX: Aᵀ
    bf16 and g f32), through the raw wrapper, which picks the role's bf16
    variant from the dtypes, against ``_cw_bmm_raw`` in interpret mode on
    the same stored operands (it widens them to f32 as the kernel does):
    within CW_RTOL of each output's sum of |terms|.  The variant's plain
    version is ``cw_bmm_plain`` on the widened operands, bit for bit."""
    shape = (3, 8, 8, 32)
    a, at = _bf16(rng, shape)
    x, xt = _bf16(rng, shape)
    g = rng.normal(size=shape).astype(np.float32)
    gt = torch.from_numpy(g)
    XT, AT = np.swapaxes(x, 1, 2), np.swapaxes(a, 1, 2)
    base, (L, R), (jl, jr) = {
        "fwd": (k5.FWD, (at, xt), (_jbf16(a), _jbf16(x))),
        "da": (k5.DA, (gt, xt.transpose(1, 2)), (jnp.asarray(g),
                                                 _jbf16(XT))),
        "dx": (k5.DX, (at.transpose(1, 2), gt), (_jbf16(AT),
                                                 jnp.asarray(g))),
    }[role]
    assert base.variant(torch.bfloat16, True).NAME == \
        base.NAME.replace("_f32", "_bf16")
    out = k5.cw_bmm(base, L, R)
    assert out.dtype == torch.float32 and out.is_contiguous()
    ref = np.asarray(_cw_bmm_raw(jl, jr, interpret=True))
    mag = k5.cw_bmm_plain(L.float().abs(), R.float().abs()).numpy()
    _within(out.numpy(), ref, mag)
    assert torch.equal(out, k5.cw_bmm_plain(L.float(), R.float()))
    assert all(r.launches == 0 for r in k5.BF16_ROLES)   # no kernel here


def test_cw_bmm_bf16_grads_match_the_tpu_kernel(rng):
    """``ChannelwiseBmm`` on bf16 A and X against ``jax.vjp`` of
    ``channelwise_bmm(..., interpret=True)``, whose ``_cw_bwd`` runs the
    TPU kernel on an f32 cotangent and the widened swapped operands and
    returns each gradient in its operand's dtype: the forward f32 within
    CW_RTOL of the sums of |terms|, the bf16 gradients within that and one
    bf16 step more."""
    shape = (3, 8, 8, 32)
    a, at = _bf16(rng, shape)
    x, xt = _bf16(rng, shape)
    w = rng.normal(size=shape).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda p, q: jx_cw(p, q, True), _jbf16(a),
                           _jbf16(x))
    dA_ref, dX_ref = (_f32(v) for v in vjp(jnp.asarray(w)))
    A = at.clone().requires_grad_()
    X = xt.clone().requires_grad_()
    out = k5.ChannelwiseBmm.apply(A, X)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.dtype == torch.float32
    assert A.grad.dtype == X.grad.dtype == torch.bfloat16
    plain = k5.cw_bmm_plain
    aa, ax, aw = (torch.from_numpy(np.abs(v)) for v in (a, x, w))
    _within(out.detach().numpy(), np.asarray(out_ref),
            plain(aa, ax).numpy())
    _within(A.grad.float().numpy(), dA_ref,
            plain(aw, ax.transpose(1, 2)).numpy(), rounded=True)
    _within(X.grad.float().numpy(), dX_ref,
            plain(aa.transpose(1, 2), aw).numpy(), rounded=True)


def test_cw_bmm_bf16_refusals(rng):
    """The raw wrapper takes no forward of two dtypes, and no cotangent
    other than f32 in the gradient roles: no variant would fit, and none
    is guessed."""
    _, a = _bf16(rng, (2, 4, 4, 8))
    f = a.float()
    with pytest.raises(TypeError, match="share one dtype"):
        k5.cw_bmm(k5.FWD, a, f)
    with pytest.raises(TypeError, match="cotangent"):
        k5.cw_bmm(k5.DA, a, a)
    with pytest.raises(TypeError, match="cotangent"):
        k5.cw_bmm(k5.DX, f, a)
    with pytest.raises(TypeError):
        k5.cw_bmm(k5.FWD, a.half(), a.half())


def _masked(rng, shape, empty_graph=True):
    """f32 data of ``shape`` (b, n, n, d) and a (b, n, n) mask of graphs
    of random sizes, the last one all-masked where ``empty_graph``."""
    b, n = shape[:2]
    data = rng.normal(size=shape).astype(np.float32)
    sizes = rng.integers(1, n + 1, b)
    if empty_graph:
        sizes[-1] = 0
    node = np.arange(n)[None, :] < sizes[:, None]
    return data, node[:, :, None] & node[:, None, :]


@pytest.mark.parametrize("dim1,dim2", [(2, 1), (1, 1), (2, 2), (1, 2)])
def test_mamamm_bf16_matches_jax(rng, monkeypatch, dim1, dim2):
    """``mamamm`` on bf16 MaskedTensors goes through K5 once (its bf16
    variant's plain version) and returns bf16, against the JAX ``mamamm``
    on the same bf16 operands (on the CPU an einsum accumulating in f32,
    cast to bf16): within CW_RTOL of the sums of |terms| and one bf16
    step; an all-masked graph gives 0."""
    calls = []
    plain = k5.cw_bmm_plain
    monkeypatch.setattr(k5, "cw_bmm_plain",
                        lambda p, q: calls.append(p.dtype) or plain(p, q))
    shape = (3, 8, 8, 16)
    a, am = _masked(rng, shape)
    b, bm = _masked(rng, shape, empty_graph=False)
    a = torch.from_numpy(a).bfloat16().float().numpy()
    b = torch.from_numpy(b).bfloat16().float().numpy()
    om = am | bm
    ref = jx_mamamm(JxMaskedTensor(_jbf16(a), jnp.asarray(am)), dim1,
                    JxMaskedTensor(_jbf16(b), jnp.asarray(bm)), dim2,
                    jnp.asarray(om))
    out = mamamm(MaskedTensor(torch.from_numpy(a).bfloat16(),
                              torch.from_numpy(am)), dim1,
                 MaskedTensor(torch.from_numpy(b).bfloat16(),
                              torch.from_numpy(bm)), dim2,
                 torch.from_numpy(om))
    assert calls == [torch.bfloat16] and out.data.dtype == torch.bfloat16
    fa = np.where(am[..., None], np.abs(a), 0)
    fb = np.where(bm[..., None], np.abs(b), 0)
    fa = fa if dim1 == 2 else np.swapaxes(fa, 1, 2)
    fb = fb if dim2 == 1 else np.swapaxes(fb, 1, 2)
    mag = plain(torch.from_numpy(fa), torch.from_numpy(fb)).numpy()
    _within(out.data.float().numpy(), _f32(ref.data), mag, rounded=True)
    assert np.all(out.data.float().numpy()[-1] == 0)


# -- the SD mode's batches and spmamm ---------------------------------------

def _datas(port, split="val", n_graphs=6):
    if port:
        pre = Mapretransform(partial(spdsampler, hop=HOP))
        return [pre(g) for g in synthetic_zinc(split, n_graphs=n_graphs)]
    pre = JxMapretransform(partial(jx_spdsampler, hop=HOP))
    return [pre(g) for g in jx_synthetic_zinc(split, n_graphs=n_graphs)]


def _same_batch(pb, jb):
    """Every array the JAX batch has, equal in dtype and value (the
    plans, whose form differs, are checked by the caller)."""
    for k in jb:
        if k.startswith("spmamm"):
            continue
        assert pb[k].dtype == np.asarray(jb[k]).dtype, k
        assert np.array_equal(pb[k], np.asarray(jb[k])), k


def test_collate_dense_sparse_adjacency_matches_jax():
    """``collate_dense(denseadj=False)``: six graphs padded to eight, the
    sparse adjacency's indices, values and count, every other array, and
    the buckets of n and edges, equal to the JAX package's."""
    pb_, jb_ = {}, {}
    pb = collate_dense(_datas(True), ("",), num_graphs=8, buckets=pb_,
                       denseadj=False)
    jb = jx_collate_dense(_datas(False), ("",), num_graphs=8, buckets=jb_,
                          denseadj=False)
    assert pb.keys() == jb.keys() and "A_data" not in pb
    _same_batch(pb, jb)
    assert pb_ == jb_ and set(pb_) == {"n", "edges"}
    assert int(pb["A_nnz"]) == sum(d["num_edges"] for d in _datas(True))


@pytest.mark.parametrize("dim1,n_extra", [(1, 0), (2, 0), (1, 1), (2, 1),
                                          (1, 2)])
def test_spmamm_triples_match_jax(dim1, n_extra):
    """The fused route's host triples, bit for bit: the same int64 array
    as the JAX package's ``spmamm_triples``, for both contracted dims and
    zero to two extra axes of B, on a padded SD batch."""
    pb = collate_dense(_datas(True), ("",), num_graphs=8, denseadj=False)
    counts = pb["node_mask"].sum(1).astype(np.int64)
    n_pad = pb["x"].shape[1]
    out = spmamm_triples(pb["A_indices"], dim1, n_pad, counts, n_extra)
    ref = jx_triples(pb["A_indices"], dim1, n_pad, counts, n_extra)
    assert out.dtype == ref.dtype == np.int64
    assert np.array_equal(out, ref) and out.shape[1] > 100


@pytest.mark.parametrize("seed", [0, 7])
def test_ma_dataloader_sd_plans_matches_jax(seed):
    """``MaDataloader(denseadj=False, build_plans=True)``, shuffled with
    ``drop_last``, two epochs, against the JAX loader (``workers=1``:
    its thread pool grows the shared buckets in no fixed order,
    ``pygho_tpu/hodata/loader.py:104-125``): every array equal; in place
    of the JAX chunk plans, K1's triples are the JAX package's
    ``spmamm_triples`` of the same batch (int32), with their row pointer
    over the flat rows and the backward orders of
    ``hodata.loader.backward_orders``."""
    pdl = MaDataloader(_datas(True, "train", 20), 8, denseadj=False,
                       build_plans=True, shuffle=True, drop_last=True,
                       seed=seed)
    jdl = JxMaDataloader(_datas(False, "train", 20), 8, denseadj=False,
                         build_plans=True, plan_geometry="auto",
                         shuffle=True, drop_last=True, seed=seed,
                         device_put=False, prefetch=0, workers=1)
    key = "spmamm___1___2"
    for _ in range(2):
        pbs, jbs = list(pdl), list(jdl)
        assert len(pbs) == len(jbs) == 2
        for pb, jb in zip(pbs, jbs):
            _same_batch(pb, jb)
            b, n = pb["x"].shape[:2]
            rows, nnz_pad = b * n * n, pb["A_indices"].shape[1]
            tuv = jx_triples(jb["A_indices"], 1, n,
                             jb["node_mask"].sum(1).astype(np.int64), 1)
            assert np.array_equal(pb[f"{key}___acd"], tuv.astype(np.int32))
            assert np.array_equal(pb[f"{key}___rowptr"],
                                  row_pointer(tuv[0], rows))
            for role, (btuv, rp) in backward_orders(tuv, nnz_pad,
                                                    rows).items():
                assert np.array_equal(pb[f"{key}___acd_{role}"], btuv)
                assert np.array_equal(pb[f"{key}___rowptr_{role}"], rp)


def _sd_case(rng, D=128):
    """A padded SD batch of six graphs in eight, with random per-channel
    edge values A (E_pad, D) and tuple features B (b, n, n, D), zero on
    padding, as numpy, and the batch."""
    pb = collate_dense(_datas(True), ("",), num_graphs=8, denseadj=False)
    nnz, E_pad = int(pb["A_nnz"]), pb["A_indices"].shape[1]
    A = rng.normal(size=(E_pad, D)).astype(np.float32)
    A[nnz:] = 0
    B = rng.normal(size=pb["X_mask"].shape + (D,)).astype(np.float32)
    B = np.where(pb["X_mask"][..., None], B, 0).astype(np.float32)
    return pb, A, B


def _jx_spmamm(pb, A, B, aggr, plans, dense):
    """JAX's spmamm(A, 1, B, 2) with the densify route on or off, its
    value and (dA, dB) under a fixed cotangent."""
    b, n = pb["x"].shape[:2]
    mask = jnp.asarray(pb["X_mask"])

    def f(a, x):
        At = JxSparseTensor(jnp.asarray(pb["A_indices"]), a,
                            jnp.asarray(pb["A_nnz"], jnp.int32), (b, n, n))
        return jx_spmamm(At, 1, JxMaskedTensor(x, mask), 2, mask,
                                    aggr, plans=plans).data

    jx_set_dense_spmamm(dense)
    try:
        return jax.vjp(f, jnp.asarray(A), jnp.asarray(B))
    finally:
        jx_set_dense_spmamm(True)


def _pt_spmamm(pb, A, B, aggr, plans, dense, W):
    """The port's spmamm(A, 1, B, 2), its value and gradients under the
    cotangent W."""
    dd = batch_to_dense_dict(pb, ("",), torch.device("cpu"))
    a = torch.from_numpy(A).requires_grad_()
    x = torch.from_numpy(B).requires_grad_()
    At = SparseTensor(dd["A"].indices, a, dd["A"].nnz, dd["A"].sparse_shape)
    set_dense_spmamm(dense)
    try:
        out = spmamm(At, 1, MaskedTensor(x, dd["X_mask"]), 2,
                                   dd["X_mask"], aggr, plans=plans).data
    finally:
        set_dense_spmamm(True)
    (out * torch.from_numpy(W)).sum().backward()
    return out.detach().numpy(), a.grad.numpy(), x.grad.numpy()


def _port_plans(pb):
    batch = dict(pb)
    add_spmamm_triples(batch, ((1, 2),), 3)
    return batch_to_dense_dict(batch, ("",), torch.device("cpu"))[
        "spmamm___1___2___plan"]


@pytest.mark.parametrize("route,aggr,exact", [
    ("densify", "sum", True), ("densify", "mean", True),
    ("gather", "sum", True), ("gather", "mean", True),
    ("gather", "max", True), ("gather", "min", True),
    ("fused", "sum", True), ("fused", "mean", True),
    ("fused", "sum", False), ("fused", "mean", False)])
def test_spmamm_route_matches_jax(rng, monkeypatch, route, aggr, exact):
    """``spmamm(A, 1, B, 2)`` of NGNN-SD with per-channel edge values at
    D = 128, on each route, value and both gradients, against the JAX
    ``spmamm`` on the same route: densify (K5's plain version against the
    JAX einsum), gather (``set_dense_spmamm(False)`` on both sides), fused
    (K1 on the loader's triples against K2, the v1 TPU kernel, in
    interpret mode on ``build_spmamm_plans`` chunk plans), exact and in
    fast math (``set_fused_math(False)`` on both sides; both round the
    operands and each product to bf16, and the gradient roles the
    cotangent: one bf16 step more).  Within CW_RTOL of the
    same quantity computed on |A|, |B| and |W| with the sum (the mean for
    ``mean``): sums in other orders; max and min take the same products.
    The route taken is checked through the kernels' plain versions."""
    pb, A, B = _sd_case(rng)
    W = rng.normal(size=B.shape).astype(np.float32)
    b, n = pb["x"].shape[:2]
    jplans = pplans = None
    if route == "fused":
        jplans = build_spmamm_plans(
            pb["A_indices"], pb["A_indices"].shape[1], 1, n, b, 3,
            pb["node_mask"].sum(1).astype(np.int64), D=128,
            geometry="auto")
        pplans = _port_plans(pb)
    calls = []
    for mod, name in ((k5, "cw_bmm_plain"), (k1, "contract_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, partial(
            lambda fn, name, *a, **k: calls.append(name) or fn(*a, **k),
            fn, name))
    was = pt_kernels.get_fused_math()
    jx_set_fused_math(exact)
    pt_kernels.set_fused_math(exact)
    try:
        dense = route != "gather"
        ref, vjp = _jx_spmamm(pb, A, B, aggr, jplans, dense)
        dA_ref, dB_ref = (np.asarray(v) for v in vjp(jnp.asarray(W)))
        out, dA, dB = _pt_spmamm(pb, A, B, aggr, pplans, dense, W)
        mags = _pt_spmamm(pb, np.abs(A), np.abs(B),
                          "mean" if aggr == "mean" else "sum", pplans,
                          dense, np.abs(W))
    finally:
        jx_set_fused_math(True)
        pt_kernels.set_fused_math(was)
    want = {"densify": {"cw_bmm_plain"}, "gather": set(),
            "fused": {"contract_plain"}}[route]
    assert set(calls) == want
    for got, r, mag in zip((out, dA, dB), (np.asarray(ref), dA_ref, dB_ref),
                           mags):
        assert got.shape == r.shape
        allow = CW_RTOL * mag
        if not exact:   # a cotangent rounded to bf16 on both sides
            allow = allow + BF16_STEP * np.abs(r)
        assert np.all(np.abs(got - r) <= allow + 1e-30), \
            float(np.max(np.abs(got - r) - allow))
    assert np.abs(out).max() > 1                        # not vacuous
    assert np.all(out[~pb["X_mask"]] == 0) or aggr in ("max", "min")


# -- layers, models, predictor, training --------------------------------

def _jx_A(pb, mode, rng, D):
    """The adjacency the conv sees after the encoder: a (b, n, n, D)
    MaskedTensor (DD) or a SparseTensor with (E_pad, D) values (SD)."""
    if mode == "DD":
        data = rng.normal(size=pb["A_mask"].shape + (D,)).astype(np.float32)
        return data
    E_pad = pb["A_indices"].shape[1]
    vals = rng.normal(size=(E_pad, D)).astype(np.float32)
    vals[int(pb["A_nnz"]):] = 0
    return vals


@pytest.mark.parametrize("mode,route", [("DD", None), ("SD", "densify"),
                                        ("SD", "fused")])
def test_ngnnconv_matches_jax(rng, mode, route):
    """``NGNNConv`` 32 -> 32 (the converged row's two-layer MLP) after
    ``load_jax_params``, in train mode (the norms' batch statistics over
    the valid tuples), on an encoded batch of six graphs in eight:
    within 1e-5 abs of the JAX layer's output (values of order 1; f32
    sums in other orders), and the running statistics within 1e-5."""
    D = 32
    dense = mode == "DD"
    pb = collate_dense(_datas(True), ("",), num_graphs=8, denseadj=dense)
    if route == "fused":
        add_spmamm_triples(pb, ((1, 2),), 3)
    jb = jx_collate_dense(_datas(False), ("",), num_graphs=8,
                          denseadj=dense)
    a = _jx_A(pb, mode, rng, D)
    x = rng.normal(size=pb["X_mask"].shape + (D,)).astype(np.float32)
    jconv = jx_conv.NGNNConv(D, D, "sum", mode, dict(MLPD),
                             rngs=nnx.Rngs(3))
    _randomize_bn(jconv, rng)
    pconv = pt_conv.NGNNConv(D, D, "sum", mode, dict(MLPD), **GEN)
    load_jax_params(pconv, _flat(jconv))
    jconv.train()
    pconv.train()
    b, n = pb["x"].shape[:2]
    jdd = jx_to_dict(jb)
    pdd = batch_to_dense_dict(pb, ("",), torch.device("cpu"))
    JX = JxMaskedTensor(jnp.asarray(x), jnp.asarray(pb["X_mask"]))
    PX = MaskedTensor(torch.from_numpy(x), pdd["X_mask"])
    if dense:
        JA = JxMaskedTensor(jnp.asarray(a), jnp.asarray(pb["A_mask"]))
        PA = MaskedTensor(torch.from_numpy(a), pdd["A_mask"])
    else:
        JA = JxSparseTensor(jnp.asarray(pb["A_indices"]), jnp.asarray(a),
                            jnp.asarray(pb["A_nnz"], jnp.int32), (b, n, n))
        PA = SparseTensor(pdd["A"].indices, torch.from_numpy(a),
                          pdd["A"].nnz, pdd["A"].sparse_shape)
    ref = np.asarray(jconv(JA, JX, jdd).data)
    with torch.no_grad():
        out = pconv(PA, PX, pdd)
    assert isinstance(out, MaskedTensor)
    valid = pb["X_mask"]
    assert np.abs(out.data.numpy()[valid] - ref[valid]).max() < 1e-5
    assert np.abs(ref[valid]).max() > 1
    targets = dict(pconv.named_buffers())
    for path, val in _flat(jconv).items():
        name = ".".join(str(p) for p in path)
        if name in targets:
            assert np.allclose(targets[name].numpy(), val, rtol=1e-5,
                               atol=1e-5), name


def _models(rng, L=2, H=32, **kw):
    jkw = dict(kw)
    if "dtype" in kw:
        jkw["dtype"] = jnp.bfloat16 if kw["dtype"] is not None else None
    jm = jx_make_ma_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                          seed=3, **POOLS, **jkw)
    _randomize_bn(jm, rng)
    pm = make_ma_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                       device="cpu", **POOLS, **kw)
    load_jax_params(pm, _flat(jm))
    return jm, pm


@pytest.mark.parametrize("mode,route,bf16", [
    ("DD", None, False), ("DD", None, True),
    ("SD", "densify", False), ("SD", "fused", False)])
def test_mamodel_ngnn_matches_jax(rng, monkeypatch, mode, route, bf16):
    """``MaModel("NGNN")`` 2 x 32 on six graphs padded to eight (two
    all-masked graphs), eval mode, with the JAX weights and seeded
    BatchNorm statistics carried across: DD in f32 and with bf16 compute
    (``dtype=torch.bfloat16`` against the JAX model's ``jnp.bfloat16``),
    and SD on the densify route and on the fused route (K1 on the
    loader's triples; the JAX model on its loader's plans).  Within 1e-5
    abs in f32 (predictions of order 1, sums in other orders through two
    layers) and BF16_PRED_RTOL of max(|prediction|, 1) with bf16
    compute.  The kernel each path
    takes is checked through the plain versions: K5's f32 or bf16 variant,
    or K1."""
    dense = mode == "DD"
    plans = route == "fused"
    jm, pm = _models(rng, mode=mode,
                     dtype=torch.bfloat16 if bf16 else None)
    assert parse_spmamm_dims(pm) == jx_spmamm_dims(jm) \
        == ([] if dense else [(1, 2)])
    jb = next(iter(JxMaDataloader(_datas(False), 8, denseadj=dense,
                                  build_plans=plans, plan_geometry="auto",
                                  device_put=False, prefetch=0, workers=1)))
    pb = next(iter(MaDataloader(_datas(True), 8, denseadj=dense,
                                build_plans=plans)))
    calls = []
    for mod, name in ((k5, "cw_bmm_plain"), (k1, "contract_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, partial(
            lambda fn, name, *a, **k: calls.append((name, a[0].dtype))
            or fn(*a, **k), fn, name))
    jm.eval()
    pm.eval()
    ref = np.asarray(jm(jx_to_dict(jb)))
    with torch.no_grad():
        out = pm(batch_to_dense_dict(pb, ("",), torch.device("cpu")))
    want = ("contract_plain", torch.float32) if plans else \
        ("cw_bmm_plain", torch.bfloat16 if bf16 else torch.float32)
    assert calls == [want] * 2
    assert out.shape == (8, 1) and out.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    tol = BF16_PRED_RTOL * np.maximum(np.abs(ref), 1) if bf16 else 1e-5
    assert np.all(np.abs(out.numpy() - ref) <= tol)
    assert np.abs(ref).max() > 0.1


def test_ma_predictor_sd_matches_jax(rng):
    """``MaPredictor(denseadj=False)`` against the JAX one on 13 raw
    graphs in batches of 8 (the densify route: neither builds plans): the
    same predictions in input order, within 1e-5 abs."""
    jm, pm = _models(rng, mode="SD")
    graphs = jx_synthetic_zinc("val", n_graphs=13)
    ref = JxMaPredictor(jm, partial(jx_spdsampler, hop=HOP), batch_size=8,
                        denseadj=False)(graphs)
    pred = MaPredictor(pm, partial(spdsampler, hop=HOP), batch_size=8,
                       denseadj=False, device="cpu")
    out = pred(synthetic_zinc("val", n_graphs=13))
    assert out.shape == (13, 1)
    assert np.abs(out - ref).max() < 1e-5


def test_ngnn_dense_training_trajectory_matches_jax():
    """NGNN-DD 2 x 32, 16 graphs in shuffled batches of 8, five AdamW
    steps at lr 1e-3 through the port's ``make_dense_steps`` and the JAX
    package's, from the same weights (the JAX loader with ``workers=1``,
    its batches in a fixed order).  Per-step losses within 1e-4 relative:
    f32 on both sides, sums in other orders through forward, backward
    (K5's dA and dX roles, the latter into the adjacency embedding) and
    five optimizer steps."""
    L, H, G, BS, STEPS, LR = 2, 32, 16, 8, 5, 1e-3
    jm = jx_make_ma_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                          **POOLS)
    pm = make_ma_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                       device="cpu", **POOLS)
    load_jax_params(pm, _flat(jm))
    jdl = JxMaDataloader(_datas(False, "train", G), BS, shuffle=True,
                         drop_last=True, seed=3, device_put=False,
                         prefetch=0, workers=1)
    pdl = MaDataloader(_datas(True, "train", G), BS, shuffle=True,
                       drop_last=True, seed=3)
    jstep, _ = jx_training.make_dense_steps()
    jopt = jx_training.make_optimizer(jm, LR)
    pstep, peval = make_dense_steps()
    popt = make_optimizer(pm, LR)
    jm.train()
    pm.train()

    def batches(dl):
        while True:
            yield from dl

    jl, pl = [], []
    for jb, pb, _ in zip(batches(jdl), batches(pdl), range(STEPS)):
        jl.append(float(jstep(jm, jopt, jb)))
        pl.append(float(pstep(pm, popt, pb)))
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-4 * np.abs(jl)), (pl, jl)
    assert len(set(pl.tolist())) == STEPS       # the model does move
    assert pm.data_encoder.ea_encoder.weight.grad.abs().sum() > 0
    pm.eval()
    s, c = peval(pm, next(iter(pdl))).tolist()
    assert c == BS and np.isfinite(s)
