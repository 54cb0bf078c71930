"""The dense ("DD") and sparse-adjacency ("SD") operators of the subgraph
convs against the JAX package, on the CPU: the ``MaskedTensor`` methods
(``diag``, ``unpooling``, ``diagonalapply``, ``catvalue``), every
operator of ``honn/ma_operator.py`` through the ``tensorop`` dispatch in
both modes (node, within-subgraph, cross-subgraph and 3-tuple message
passing, the diagonal, the pooling and the unpooling), each with its
values and the gradients of both operands, ``rdsampler``, and what stays
refused.

Inputs are a batch of six ``synthetic_zinc`` graphs padded to eight
(hop-4 ``spdsampler``, n padded to 32 in a 32-bucket), values from numpy
seeds, and 4-D MaskedTensors built from the batch's node masks for the
3-tuple operators.  Each test states its tolerance.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.backend.matensor import MaskedTensor as JxMaskedTensor
from pygho_tpu.backend.spmamm import set_dense_spmamm as jx_set_dense_spmamm
from pygho_tpu.backend.sptensor import SparseTensor as JxSparseTensor
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.ma_sampler import rdsampler as jx_rdsampler
from pygho_tpu.honn import tensorop as jx_tensorop
from pygho_tpu.kernels.fused_spmamm import build_spmamm_plans

from pygho_tpu_torch.backend.matensor import MaskedTensor
from pygho_tpu_torch.backend.spmamm import set_dense_spmamm
from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.hodata import (Mapretransform, add_spmamm_triples,
                                    batch_to_dense_dict, collate_dense,
                                    rdsampler, spdsampler, synthetic_zinc)
from pygho_tpu_torch.honn import tensorop as pt_tensorop
from pygho_tpu_torch.kernels import channelwise_bmm as k5
from pygho_tpu_torch.kernels import spspmm_sum as k1
from pygho_tpu_torch.models import make_ma_model
from test_torch_dense_subgraph_models import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
D = 16
# f32 sums of the same products in other orders (einsum, K5's plain
# version, K1's plain version, the JAX einsum and K2 in interpret mode):
# each output within RTOL of its sum of |terms|, which the same operator
# computes on |inputs| and |cotangent|
RTOL = 1e-5


def _batch(denseadj, plan_dims=()):
    """Six graphs padded to eight, the dense or the sparse adjacency;
    with ``plan_dims`` the fused route's triples for those pairs."""
    pre = Mapretransform(partial(spdsampler, hop=4))
    datas = [pre(g) for g in synthetic_zinc("val", n_graphs=6)]
    pb = collate_dense(datas, ("",), num_graphs=8, denseadj=denseadj)
    if plan_dims:
        add_spmamm_triples(pb, plan_dims, 3)
    return pb


def _node_masks(pb, ndim):
    """The (b, n, ..., n) mask of ``ndim`` node axes: every node of the
    tuple real."""
    node = pb["node_mask"]
    m = node
    for k in range(1, ndim):
        m = m[..., None] & node.reshape(node.shape[:1] + (1,) * k
                                        + node.shape[1:])
    return m


def _normal(rng, mask, d=D):
    """Normal f32 values of ``mask``'s shape + (d,), zero off the mask
    (the padding entries ``mamamm`` fills anyway) where ``mask``."""
    x = rng.normal(size=mask.shape + (d,)).astype(np.float32)
    return np.where(mask[..., None], x, 0).astype(np.float32)


def _adj(rng, pb, d=D):
    """The adjacency's values: (b, n, n, d) on its mask (DD) or (E_pad, d)
    zero on the padding rows (SD)."""
    if "A_mask" in pb:
        return _normal(rng, pb["A_mask"], d)
    E_pad = pb["A_indices"].shape[1]
    vals = rng.normal(size=(E_pad, d)).astype(np.float32)
    vals[int(pb["A_nnz"]):] = 0
    return vals


def _A(side, pb, a):
    """The adjacency as JAX's (``side == "jx"``) or the port's tensor."""
    b, n = pb["x"].shape[:2]
    if side == "jx":
        if "A_mask" in pb:
            return JxMaskedTensor(a, jnp.asarray(pb["A_mask"]))
        return JxSparseTensor(jnp.asarray(pb["A_indices"]), a,
                              jnp.asarray(pb["A_nnz"], jnp.int32), (b, n, n))
    if "A_mask" in pb:
        return MaskedTensor(a, torch.from_numpy(pb["A_mask"]))
    return SparseTensor(torch.from_numpy(pb["A_indices"]).long(), a,
                        int(pb["A_nnz"]), (b, n, n))


def _M(side, data, mask):
    if side == "jx":
        return JxMaskedTensor(data, jnp.asarray(mask))
    return MaskedTensor(data, torch.from_numpy(mask))


def _both(jfn, pfn, args, W):
    """``jfn`` and ``pfn`` (each mapping its side's array arguments to an
    output array) on the numpy ``args``: the JAX value and vjp under the
    cotangent ``W``, the port's value and gradients, and the port's on
    |args| and |W| (the sums of |terms|)."""
    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(W))

    def port(arrs, w):
        ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
              for a in arrs]
        out = pfn(*ts)
        (out * torch.from_numpy(w)).sum().backward()
        return [out.detach().numpy()] + [t.grad.numpy() for t in ts]

    got = port(args, W)
    mag = port([np.abs(a) for a in args], np.abs(W))
    return [np.asarray(ref)] + [np.asarray(g) for g in jgrads], got, mag


def _held(refs, gots, mags, rtol=RTOL):
    for what, r, g, m in zip(("value",) + tuple(f"grad {i}" for i in
                                                range(len(refs) - 1)),
                             refs, gots, mags):
        assert g.shape == r.shape, what
        allow = rtol * m + 1e-30
        assert np.all(np.abs(g - r) <= allow), \
            (what, float(np.max(np.abs(g - r) - allow)))
    assert np.abs(refs[0]).max() > 0.1        # not vacuous


# -- MaskedTensor ------------------------------------------------------

@pytest.mark.parametrize("ndim,dims", [(2, [1, 2]), (3, [1, 2]),
                                       (3, [1, 3]), (3, [2, 3])])
def test_masked_diag_matches_jax(rng, ndim, dims):
    """``MaskedTensor.diag`` of two dims of (b, n, n) and (b, n, n, n)
    tensors: the same values and mask as JAX's (a gather, bit for
    bit), a view of the data, and its gradient (a scatter of the
    cotangent) bit for bit."""
    pb = _batch(True)
    mask = _node_masks(pb, ndim)
    x = _normal(rng, mask, 4)
    jref = JxMaskedTensor(jnp.asarray(x), jnp.asarray(mask)).diag(dims)
    X = torch.from_numpy(x).requires_grad_()
    out = MaskedTensor(X, torch.from_numpy(mask)).diag(dims)
    assert out.data._base is X                          # a view
    assert np.array_equal(out.data.detach().numpy(), np.asarray(jref.data))
    assert np.array_equal(out.mask.numpy(), np.asarray(jref.mask))
    W = rng.normal(size=out.shape).astype(np.float32)
    (out.data * torch.from_numpy(W)).sum().backward()
    _, vjp = jax.vjp(lambda v: JxMaskedTensor(v, jnp.asarray(mask))
                     .diag(dims).data, jnp.asarray(x))
    assert np.array_equal(X.grad.numpy(), np.asarray(vjp(jnp.asarray(W))[0]))


@pytest.mark.parametrize("ndim,dims", [(2, [1]), (2, [2]), (3, [3]),
                                       (3, [1, 2])])
def test_masked_unpooling_matches_jax(rng, ndim, dims):
    """``MaskedTensor.unpooling`` of a tensor with ``len(dims)`` fewer
    masked dims onto a (b, n, n) or (b, n, n, n) target: JAX's values bit
    for bit, the target's mask, an ``expand`` (stride 0 along each new
    dim: no copy), and its gradient (the cotangent summed over the new
    dims) within RTOL of the sums of |cotangent|."""
    pb = _batch(True)
    tmask = _node_masks(pb, ndim)
    smask = _node_masks(pb, ndim - len(dims))
    x = _normal(rng, smask, 4)
    tar = _normal(rng, tmask, 4)
    jt = JxMaskedTensor(jnp.asarray(tar), jnp.asarray(tmask))
    jref = JxMaskedTensor(jnp.asarray(x), jnp.asarray(smask)) \
        .unpooling(dims, jt)
    X = torch.from_numpy(x).requires_grad_()
    pt = _M("pt", torch.from_numpy(tar), tmask)
    out = MaskedTensor(X, torch.from_numpy(smask)).unpooling(dims, pt)
    assert out.mask is pt.mask
    assert all(out.data.stride(d) == 0 for d in dims)
    assert np.array_equal(out.data.detach().numpy(), np.asarray(jref.data))
    W = rng.normal(size=out.shape).astype(np.float32)
    (out.data * torch.from_numpy(W)).sum().backward()
    _, vjp = jax.vjp(lambda v: JxMaskedTensor(v, jnp.asarray(smask))
                     .unpooling(dims, jt).data, jnp.asarray(x))
    mag = np.abs(W).sum(axis=tuple(dims))
    assert np.all(np.abs(X.grad.numpy() - np.asarray(vjp(jnp.asarray(W))[0]))
                  <= RTOL * mag)


def test_masked_diagonalapply_and_catvalue_match_jax(rng):
    """``diagonalapply`` hands ``func`` the data and the int32 diagonal
    mask of (b, n, n), as JAX's (the same ``eye`` and the mask kept), and
    ``catvalue`` concatenates the zero-filled values of a list or of one
    tensor: bit for bit; a 4-D ``diagonalapply`` and ``samesparse=False``
    raise."""
    pb = _batch(True)
    mask = _node_masks(pb, 2)
    xs = [rng.normal(size=mask.shape + (3,)).astype(np.float32)
          for _ in range(3)]
    J = [JxMaskedTensor(jnp.asarray(x), jnp.asarray(mask)) for x in xs]
    P = [_M("pt", torch.from_numpy(x), mask) for x in xs]
    seen = {}

    def jfunc(data, eye):
        seen["jx"] = np.asarray(eye)
        return data * eye[..., None]

    def pfunc(data, eye):
        seen["pt"] = eye
        return data * eye[..., None]

    jd, pd = J[0].diagonalapply(jfunc), P[0].diagonalapply(pfunc)
    assert seen["pt"].dtype == torch.int32
    assert np.array_equal(seen["pt"].numpy(), seen["jx"])
    assert np.array_equal(pd.data.numpy(), np.asarray(jd.data))
    assert pd.mask is P[0].mask
    for jc, pc in ((J[0].catvalue(J[1:], True), P[0].catvalue(P[1:], True)),
                   (J[0].catvalue(J[1], True), P[0].catvalue(P[1], True))):
        assert np.array_equal(pc.data.numpy(), np.asarray(jc.data))
        assert np.array_equal(pc.mask.numpy(), np.asarray(jc.mask))
    with pytest.raises(NotImplementedError, match="samesparse"):
        P[0].catvalue(P[1], False)
    m4 = _node_masks(pb, 3)
    with pytest.raises(ValueError, match=r"\(b, n, n\)"):
        _M("pt", torch.zeros(m4.shape + (1,)), m4).diagonalapply(pfunc)


# -- message passing ----------------------------------------------------

def _mp_case(rng, mode, op, route):
    """The operands and both sides' functions of one tensorop message
    passing in ``mode``: ``op`` is "node", "subg2d", "cross" or "subg3d";
    ``route`` ("densify", "gather" or "fused") picks the SD route."""
    dense = mode == "DD"
    pdims = {"subg2d": (1, 2), "cross": (1, 1)}.get(op)
    pb = _batch(dense, (pdims,) if route == "fused" else ())
    b, n = pb["x"].shape[:2]
    d = 8 if op == "subg3d" else D
    a = _adj(rng, pb, d)
    xmask = {"node": _node_masks(pb, 1), "subg3d": _node_masks(pb, 3)}.get(
        op, pb["X_mask"])
    x = _normal(rng, xmask, d)
    jdd, pdd = {}, batch_to_dense_dict(pb, ("",), CPU)
    if route == "fused":
        key = f"spmamm___{pdims[0]}___{pdims[1]}___plan"
        jdd[key] = build_spmamm_plans(
            pb["A_indices"], pb["A_indices"].shape[1], pdims[0], n, b, 3,
            pb["node_mask"].sum(1).astype(np.int64), D=d, geometry="auto")
        assert key in pdd
    name = {"node": "OpNodeMessagePassing",
            "subg2d": "OpMessagePassingOnSubg2D",
            "cross": "OpMessagePassingCrossSubg2D",
            "subg3d": "OpMessagePassingOnSubg3D"}[op]
    jop = getattr(jx_tensorop, name)(mode)
    pop = getattr(pt_tensorop, name)(mode)

    def call(side, opm, dd, av, xv):
        A, X = _A(side, pb, av), _M(side, xv, xmask)
        if op == "node":
            return opm(A, X).data
        return opm(A, X, dd, X).data

    return (a, x), partial(call, "jx", jop, jdd), \
        partial(call, "pt", pop, pdd)


@pytest.mark.parametrize("mode,op,route", [
    ("DD", "node", None), ("SD", "node", "densify"), ("SD", "node", "gather"),
    ("DD", "subg2d", None), ("SD", "subg2d", "densify"),
    ("DD", "cross", None), ("SD", "cross", "densify"),
    ("SD", "cross", "gather"), ("SD", "cross", "fused"),
    ("DD", "subg3d", None), ("SD", "subg3d", "densify")])
def test_message_passing_matches_jax(rng, monkeypatch, mode, op, route):
    """Each tensorop message passing in DD and SD mode (SD on the densify
    route, the gather route, ``set_dense_spmamm(False)`` on both sides,
    and for the cross key the fused route: K1 on the loader's ``(1, 1)``
    triples against K2 in interpret mode on ``build_spmamm_plans``), on
    the padded batch: the value and the gradients of the adjacency and of
    X within RTOL of the sums of |terms|.  The kernel each route takes is
    checked through the plain versions: K5 for the channel-wise products
    (within subgraphs at ``(2, 1)``, across them at ``(1, 1)``, the
    adjacency read through its transposed strides, and the SD densify
    route of both), K1 on the fused route, none for the node-level and
    3-tuple einsums."""
    (a, x), jfn, pfn = _mp_case(rng, mode, op, route)
    calls = []
    for mod, name in ((k5, "cw_bmm_plain"), (k1, "contract_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, partial(
            lambda fn, name, *a, **k: calls.append(name) or fn(*a, **k),
            fn, name))
    W = rng.normal(size=x.shape).astype(np.float32)
    dense = route != "gather"
    jx_set_dense_spmamm(dense)
    set_dense_spmamm(dense)
    try:
        refs, gots, mags = _both(jfn, pfn, (a, x), W)
    finally:
        jx_set_dense_spmamm(True)
        set_dense_spmamm(True)
    _held(refs, gots, mags)
    if route == "fused":
        want = {"contract_plain"}
    elif op in ("subg2d", "cross") and route != "gather":
        want = {"cw_bmm_plain"}
    else:
        want = set()
    assert set(calls) == want


# -- diagonal, pooling, unpooling --------------------------------------

@pytest.mark.parametrize("name,ndim,pool", [
    ("OpDiag2D", 2, None),
    ("OpPoolingSubg2D", 2, "mean"),
    ("OpPoolingCrossSubg2D", 2, "sum"), ("OpPoolingCrossSubg2D", 2, "mean"),
    ("OpPoolingCrossSubg2D", 2, "max"),
    ("OpPoolingSubg3D", 3, "sum"), ("OpPoolingSubg3D", 3, "mean"),
    ("OpPoolingSubg3D", 3, "max")])
def test_diag_and_pooling_match_jax(rng, name, ndim, pool):
    """The tensorop diagonal and poolings in mode "D" (the last graph of
    the batch all masked, so a pool over nothing gives 0): value and
    gradient within RTOL of the sums of |terms| (a max takes one term;
    its gradient goes to the same entry on both sides, the values being
    distinct)."""
    pb = _batch(True)
    mask = _node_masks(pb, ndim)
    x = _normal(rng, mask, 8)
    args = () if pool is None else (pool,)
    jop = getattr(jx_tensorop, name)("D", *args)
    pop = getattr(pt_tensorop, name)("D", *args)
    W = rng.normal(size=jop(JxMaskedTensor(jnp.asarray(x),
                                           jnp.asarray(mask))).data.shape
                   ).astype(np.float32)
    refs, gots, mags = _both(lambda v: jop(_M("jx", v, mask)).data,
                             lambda v: pop(_M("pt", v, mask)).data, (x,), W)
    _held(refs, gots, mags)
    out = pop(_M("pt", torch.from_numpy(x), mask))
    jout = jop(_M("jx", jnp.asarray(x), mask))
    assert np.array_equal(out.mask.numpy(), np.asarray(jout.mask))
    assert np.all(out.data.numpy()[-1] == 0)


@pytest.mark.parametrize("name", ["OpUnpoolingSubgNodes2D",
                                  "OpUnpoolingRootNodes2D"])
def test_unpooling_ops_match_jax(rng, name):
    """The tensorop unpoolings in mode "D": a node-level (b, n) tensor
    onto the (b, n, n) target, its mask carried; the value bit for bit,
    the gradient within RTOL of the sums of |cotangent|."""
    pb = _batch(True)
    nmask, tmask = _node_masks(pb, 1), pb["X_mask"]
    x, tar = _normal(rng, nmask, 8), _normal(rng, tmask, 8)
    jop, pop = getattr(jx_tensorop, name)("D"), getattr(pt_tensorop, name)("D")
    W = rng.normal(size=tar.shape).astype(np.float32)
    refs, gots, mags = _both(
        lambda v: jop(_M("jx", v, nmask), _M("jx", jnp.asarray(tar),
                                              tmask)).data,
        lambda v: pop(_M("pt", v, nmask), _M("pt", torch.from_numpy(tar),
                                              tmask)).data, (x,), W)
    assert np.array_equal(gots[0], refs[0])
    _held(refs, gots, mags)


# -- the sampler, the plan pairs and the refusals -----------------------

def test_rdsampler_matches_jax():
    """``rdsampler`` on twelve ``synthetic_zinc`` graphs: the float32
    ``(n * n, 1)`` resistance distances and the tuple shape of JAX's, bit
    for bit (the same numpy and scipy calls)."""
    for pg, jg in zip(synthetic_zinc("val", n_graphs=12),
                      jx_synthetic_zinc("val", n_graphs=12)):
        out, ref = rdsampler(pg), jx_rdsampler(jg)
        n = pg.num_nodes
        assert out["tuplefeat"].dtype == np.float32
        assert out["tuplefeat"].shape == (n * n, 1)
        assert np.array_equal(out["tuplefeat"], ref["tuplefeat"])
        assert np.array_equal(out["tupleshape"], ref["tupleshape"])
        rd = out["tuplefeat"].reshape(n, n)
        assert np.allclose(np.diagonal(rd), 0, atol=1e-4)
        assert rd.max() > 0.5


def test_what_stays_refused():
    """As in the JAX package: ``Op2FWL`` has no SD mode, a dense
    adjacency aggregates by sum only (JAX's asserts), the SD and DD modes
    take no ``message_func``, and a dense I2GNN model raises, naming the
    JAX ``MaModel``'s missing 3-tuple path."""
    with pytest.raises(NotImplementedError, match="SS and DD"):
        pt_tensorop.Op2FWL("SD")
    for name in ("OpMessagePassingOnSubg2D", "OpMessagePassingCrossSubg2D",
                 "OpMessagePassingOnSubg3D"):
        with pytest.raises(ValueError, match="only sum"):
            getattr(pt_tensorop, name)("DD", "max")
        with pytest.raises(NotImplementedError, match="message_func"):
            getattr(pt_tensorop, name)("SD", message_func=lambda *a: a)
        getattr(pt_tensorop, name)("SD", "max")        # SD takes any aggr
    with pytest.raises(ValueError, match="only sum"):
        pt_tensorop.OpNodeMessagePassing("DD", "mean")
    with pytest.raises(ValueError, match="S or D"):
        pt_tensorop.OpDiag2D("SD")
    for mode in ("DD", "SD"):
        with pytest.raises(NotImplementedError, match="JAX MaModel"):
            make_ma_model("I2GNN", num_layer=1, hiddim=8, mode=mode,
                          device="cpu")
