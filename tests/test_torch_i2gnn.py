"""I2GNN's 3-tuple path in sparse mode against the JAX package, on the
CPU, up to the layer: ``I2Sampler``, the subgraph-count dataset, the
collation of the 3-tuples' pooling map and its target pattern, the
sparse-output ``sum``/``mean`` (with values in the padding rows that must
not leak), ``OpMessagePassingOnSubg3D`` (K1 on the key
``X___X___2___A___0``) with both gradients against the JAX operator on its
XLA path and on its fused path (the TPU kernel in interpret mode), the
same operator over an adjacency without values, and ``I2Conv``.  The
model, its training and the entry points:
``tests/test_torch_i2gnn_models.py``.

Sizes are small (D <= 32 but where the JAX kernel needs 128, a few
graphs); inputs and norm statistics come from numpy seeds.  Each test
states its tolerance.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.hodata import datasets as jx_datasets
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import I2Sampler as JxI2Sampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import sp_operator as jx_op

from pygho_tpu_torch.hodata import (I2Sampler, Sppretransform,
                                    collate_sparse, count_substructures,
                                    synthetic_subgraphcount, synthetic_zinc)
from pygho_tpu_torch.backend.indexing import PAD_INDEX
from pygho_tpu_torch.hodata.loader import add_rowptr
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn import sp_operator as pt_op
from pygho_tpu_torch.honn import tensorop as pt_tensorop
from pygho_tpu_torch.kernels import get_fused_math, set_fused_math
from pygho_tpu_torch.models import make_ma_model
from pygho_tpu_torch.weights import load_jax_params
from test_torch_subgraph_convs import (CPU, GARBAGE, GEN, MLPD, _values,
                                       _with, jax_params, randomize_bn)

KEY3 = "X___X___2___A___0"
SEG = "Xpool___2___seg"
TAR = "Xpool___2___tarX"


def _datas(keys, graphs, hop=3):
    """The JAX package's per-graph precompute of ``graphs`` (port
    ``Graph``s carry the same arrays) with ``I2Sampler(hop)``."""
    pre = JxSppretransform(partial(JxI2Sampler, hop=hop), [""], keys)
    return [pre(g) for g in graphs]


def _batch(keys=(KEY3,), n_graphs=5, pad_to=8, graphs=None):
    """One collated batch of ``synthetic_zinc("val")`` graphs (or
    ``graphs``), with padded tuples, edges and triples."""
    graphs = graphs or synthetic_zinc("val", n_graphs=n_graphs)
    return jx_collate_sparse(_datas(list(keys), graphs), list(keys), [""],
                             pad_to)


def _dicts(batch, keys=(KEY3,)):
    """The JAX datadict and the port's (with row pointers and backward
    orders) of one batch."""
    pb = dict(batch)
    add_rowptr(pb, list(keys), backward=True)
    return jx_to_dict(batch), batch_to_sparse_dict(pb, ("",), CPU)


@pytest.mark.parametrize("source", ["zinc", "count"])
def test_i2sampler_matches_jax(source):
    """``I2Sampler`` at hop 3 and 2 gives the JAX sampler's arrays, equal
    element for element, on ``synthetic_zinc`` molecules and on the
    denser, often disconnected subgraph-count graphs; a tuple's two
    distances differ by at most 1 (u and v are adjacent), so one of them
    reaches ``hop + 1``; ``pool2_seg`` ascends."""
    graphs = (synthetic_zinc("train", n_graphs=6) if source == "zinc"
              else synthetic_subgraphcount(n_graphs=6, n_lo=5, n_hi=12))
    far = 0
    for g in graphs:
        for hop in (2, 3):
            ref, out = JxI2Sampler(g, hop), I2Sampler(g, hop)
            assert sorted(out) == sorted(ref)
            for k in ref:
                assert out[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(out[k], ref[k])
            tid = out["tupleid"]
            assert tid.shape[0] == 3 and out["tuplefeat"].shape == \
                (tid.shape[1], 2)
            assert np.all(np.diff(out["pool2_seg"]) >= 0)
            feat = out["tuplefeat"]
            assert np.abs(feat[:, 0] - feat[:, 1]).max() <= 1
            far += int((feat == hop + 1).sum())
    assert far > 0


@pytest.mark.parametrize("target", ["triangle", "all"])
def test_synthetic_subgraphcount_matches_jax(target):
    """``synthetic_subgraphcount`` gives the JAX set bit for bit for a
    seed: node features, edges and targets (the triangle target divided by
    10, the 6-task one by each count's standard deviation);
    ``count_substructures`` agrees with JAX's on each graph."""
    kw = dict(n_graphs=24, seed=5, target=target)
    ref, out = jx_datasets.synthetic_subgraphcount(**kw), \
        synthetic_subgraphcount(**kw)
    assert len(out) == len(ref) > 0
    for g, r in zip(out, ref):
        assert g.edge_attr is None and r.edge_attr is None
        for k in ("x", "edge_index", "y"):
            a, b = getattr(g, k), getattr(r, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b)
    adj = np.zeros((ref[0].num_nodes,) * 2, bool)
    adj[tuple(ref[0].edge_index)] = True
    assert count_substructures(adj) == jx_datasets.count_substructures(adj)
    with pytest.raises(ValueError, match="unknown target"):
        synthetic_subgraphcount(n_graphs=2, target="hexagon")


def test_collate_pool_seg_and_target_pattern():
    """The port's ``collate_sparse`` of 5 graphs padded to 8 gives the JAX
    batch's arrays, the pooling map ``Xpool___2___seg`` among them (each
    graph's parent edges offset by the edges before it, ``PAD_INDEX``
    in the padded tuples); ``batch_to_sparse_dict`` makes it an int64
    index, the tuples a 3-D SparseTensor and the pooling target the
    adjacency pattern."""
    keys = [KEY3]
    graphs = synthetic_zinc("val", n_graphs=5)
    jdatas = _datas(keys, graphs)
    pdatas = [Sppretransform(partial(I2Sampler, hop=3), [""], keys)(g)
              for g in graphs]
    ref = jx_collate_sparse(jdatas, keys, [""], 8)
    out = collate_sparse(pdatas, keys, num_graphs=8)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    seg = out[SEG]
    T, E = int(out["num_tuples"]), int(out["num_edges"])
    assert seg.shape[0] > T and np.all(seg[T:] == PAD_INDEX)
    assert np.all(np.diff(seg[:T]) >= 0) and seg[T - 1] == E - 1
    # the parent edge's ends are the tuple's first two nodes
    np.testing.assert_array_equal(out["edge_index"][:, seg[:T]],
                                  out["tupleid"][:2, :T])
    pb = dict(out)
    add_rowptr(pb, keys, backward=True)
    dd = batch_to_sparse_dict(pb, ("",), CPU)
    assert dd[SEG].dtype == torch.int64
    assert dd["X"].sparse_dim == 3 and dd["X"].nnz == T
    tar = dd[TAR]
    assert tar.values is None and tar.nnz == E
    assert tar.indices is dd["A"].indices


@pytest.mark.parametrize("pool", ["sum", "mean"])
def test_sparse_output_pooling_matches_jax(rng, pool):
    """``X.sum``/``X.mean(2, return_sparse=True, ...)`` and
    ``OpPoolingSubg3D`` onto the edge pattern against the JAX operator,
    with ``GARBAGE`` in the padded tuples' values (their map is
    ``PAD_INDEX``: dropped, and not counted by the mean): 1e-5 abs on
    means and sums of a few tens of normal terms; the padded edge rows
    come out 0."""
    batch = _batch()
    jd, pd = _dicts(batch)
    nt, D = pd["X"].nnz, 16
    xv = _values(rng, pd["X"].nnz_pad, nt, D)
    ref = jx_op.OpPoolingSubg3D(pool)(_with(jd["X"], xv), jd)
    out = pt_op.OpPoolingSubg3D(pool)(_with(pd["X"], xv), pd)
    direct = getattr(_with(pd["X"], xv), pool)(
        2, return_sparse=True, seg_ids=pd[SEG],
        tar_indices=pd[TAR].indices, tar_nnz=pd[TAR].nnz)
    assert out.sparse_shape == ref.sparse_shape == pd["A"].sparse_shape
    assert out.indices is pd["A"].indices and out.nnz == pd["A"].nnz
    ov, rv = out.values.numpy(), np.asarray(ref.values)
    assert np.abs(rv).max() > 0.3 and np.abs(rv).max() < GARBAGE
    assert np.abs(ov - rv).max() < 1e-5
    assert np.all(ov[pd["A"].nnz:] == 0)
    np.testing.assert_array_equal(direct.values.numpy(), ov)
    # through the tensorop dispatch, and the dense readout after it
    tv = pt_tensorop.OpPoolingSubg3D("S", pool)(_with(pd["X"], xv), pd)
    np.testing.assert_array_equal(tv.values.numpy(), ov)
    with pytest.raises(ValueError, match="seg_ids"):
        _with(pd["X"], xv).sum(2, return_sparse=True)


def _mp3d_case(rng, D, plans=False, n_graphs=4):
    """A batch of ``n_graphs`` graphs (the JAX loader's, with its kernel
    plans where ``plans``), its two datadicts, and tuple values X, edge
    values A and a cotangent W, garbage in the padding rows of X and A."""
    keys = [KEY3]
    jdatas = _datas(keys, synthetic_zinc("val", n_graphs=n_graphs))
    jdl = JxSpDataloader(jdatas, n_graphs, keys, device_put=False,
                         prefetch=0, workers=1, build_plans=plans,
                         plan_dim=D)
    batch = next(iter(jdl))
    jd, pd = _dicts({k: v for k, v in batch.items()
                     if not k.endswith("___plan")})
    if plans:
        jd = jx_to_dict(batch)
        assert f"{KEY3}___plan" in jd
    nt, ne = pd["X"].nnz, pd["A"].nnz
    X = _values(rng, pd["X"].nnz_pad, nt, D)
    A = _values(rng, pd["A"].nnz_pad, ne, D)
    W = _values(rng, pd["X"].nnz_pad, nt, D)
    W[nt:] = 0.0
    return jd, pd, X, A, W


def _mp3d_both(jd, pd, X, A, W):
    """The JAX operator's values and gradients (d/dX, d/dA of sum(out *
    W)) and the port's."""
    jop = jx_op.OpMessagePassingOnSubg3D()
    pop = pt_op.OpMessagePassingOnSubg3D()

    def jloss(xv, av):
        Xj = dataclasses.replace(jd["X"], values=xv)
        Aj = dataclasses.replace(jd["A"], values=av)
        out = jop(Aj, Xj, jd, Xj).values
        return (out * jnp.asarray(W)).sum(), out

    (_, ref), (gx, ga) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(X), jnp.asarray(A))
    xt = torch.from_numpy(X).requires_grad_()
    at = torch.from_numpy(A).requires_grad_()
    Xp = dataclasses.replace(pd["X"], values=xt)
    Ap = dataclasses.replace(pd["A"], values=at)
    out = pop(Ap, Xp, pd, Xp)
    (out.values * torch.from_numpy(W)).sum().backward()
    return (out, xt.grad.numpy(), at.grad.numpy()), \
        (np.asarray(ref), np.asarray(gx), np.asarray(ga))


def _check_mp3d(pd, got, ref, tol):
    (out, gx, ga), (rv, rgx, rga) = got, ref
    nt, ne = pd["X"].nnz, pd["A"].nnz
    assert out.sparse_shape == (pd["X"].sparse_shape[0],) * 3
    assert out.indices is pd["X"].indices
    ov = out.values.detach().numpy()
    assert np.abs(rv).max() > 1.0
    assert np.abs(ov - rv).max() < tol * np.abs(rv).max()
    # the gradients of the real rows; the padding rows get none
    assert np.abs(gx[:nt] - rgx[:nt]).max() < tol * np.abs(rgx).max()
    assert np.abs(ga[:ne] - rga[:ne]).max() < tol * np.abs(rga).max()
    assert not gx[nt:].any() and not ga[ne:].any()


def test_mp_subg3d_matches_jax_xla(rng):
    """``OpMessagePassingOnSubg3D`` (K1's forward, dX and dA roles on the
    key ``X___X___2___A___0``, through the loader's row pointer and
    backward orders) against the JAX operator on its XLA path, at D = 16
    on 4 graphs, values and both gradients: 1e-5 of the largest entry
    (f32 sums of a few tens of terms in another order)."""
    jd, pd, X, A, W = _mp3d_case(rng, 16)
    _check_mp3d(pd, *_mp3d_both(jd, pd, X, A, W), 1e-5)


def test_mp_subg3d_matches_jax_fused(rng):
    """The same against the JAX operator on its fused path: the TPU kernel
    (``fused_spspmm_strip``, interpret mode) on the loader's strip plans
    of 2 graphs at D = 128, values and gradients, in the exact mode (the
    default of both packages): 1e-5 of the largest entry."""
    assert get_fused_math()
    jd, pd, X, A, W = _mp3d_case(rng, 128, plans=True, n_graphs=2)
    _check_mp3d(pd, *_mp3d_both(jd, pd, X, A, W), 1e-5)


def test_mp_subg3d_over_an_adjacency_without_values(rng):
    """The subgraph-count graphs have no edge features: the adjacency
    has no values, and each term is the tuple row alone, as JAX's
    ``spspmm`` takes it.  The port runs K1 on a ones operand in the exact
    mode, in either math mode: values and d/dX within 1e-5 of JAX's, and
    the fast mode's result bit for bit the exact mode's."""
    graphs = synthetic_subgraphcount(n_graphs=3, n_lo=6, n_hi=10)
    jd, pd = _dicts(_batch(graphs=graphs))
    assert jd["A"].values is None and pd["A"].values is None
    nt, D = pd["X"].nnz, 16
    X = _values(rng, pd["X"].nnz_pad, nt, D)
    W = _values(rng, pd["X"].nnz_pad, nt, D)
    W[nt:] = 0.0

    def jloss(xv):
        Xj = dataclasses.replace(jd["X"], values=xv)
        out = jx_op.OpMessagePassingOnSubg3D()(jd["A"], Xj, jd, Xj).values
        return (out * jnp.asarray(W)).sum(), out

    (_, ref), gx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(X))
    outs = []
    old = get_fused_math()
    try:
        for exact in (True, False):
            set_fused_math(exact)
            xt = torch.from_numpy(X).requires_grad_()
            Xp = dataclasses.replace(pd["X"], values=xt)
            out = pt_op.OpMessagePassingOnSubg3D()(pd["A"], Xp, pd, Xp)
            (out.values * torch.from_numpy(W)).sum().backward()
            outs.append((out.values.detach().numpy(), xt.grad.numpy()))
    finally:
        set_fused_math(old)
    ref, gx = np.asarray(ref), np.asarray(gx)
    assert np.abs(ref).max() > 1.0
    assert np.abs(outs[0][0] - ref).max() < 1e-5 * np.abs(ref).max()
    assert np.abs(outs[0][1][:nt] - gx[:nt]).max() < 1e-5 * np.abs(gx).max()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_i2conv_matches_jax(rng):
    """``I2Conv`` with the JAX layer's weights (``load_jax_params``) and
    seeded BatchNorm statistics, in training and eval mode, on 4 graphs
    at D = 32: 2e-5 abs on outputs of order 1 (an MLP of two layers and
    the contraction, f32 in another order); the padding rows stay 0."""
    jd, pd = _dicts(_batch(n_graphs=4))
    D = 32
    mlp = {**MLPD, "numlayer": 2, "tailact": True}
    jc = jx_conv.I2Conv(D, D, "sum", "SS", mlp,
                        rngs=nnx.Rngs(0))
    randomize_bn(jc, rng)
    pc = pt_conv.I2Conv(D, D, "sum", "SS", mlp, **GEN)
    load_jax_params(pc, jax_params(jc))
    nt, ne = pd["X"].nnz, pd["A"].nnz
    xv = np.zeros((pd["X"].nnz_pad, D), np.float32)
    xv[:nt] = rng.normal(size=(nt, D))
    av = np.zeros((pd["A"].nnz_pad, D), np.float32)
    av[:ne] = rng.normal(size=(ne, D))
    for train in (True, False):
        jc.train() if train else jc.eval()
        pc.train(train)
        ref = np.asarray(jc(_with(jd["A"], av), _with(jd["X"], xv),
                            jd).values)
        with torch.no_grad():
            out = pc(_with(pd["A"], av), _with(pd["X"], xv), pd).values
        out = out.numpy()
        assert np.abs(ref).max() > 0.3
        assert np.abs(out - ref).max() < 2e-5
        assert np.all(out[nt:] == 0)


def test_i2gnn_dense_modes_stay_unported():
    """What stays unported raises: the dense I2GNN model, in both modes
    (the JAX ``MaModel`` has no 3-tuple path either; the 3-D operators
    and ``I2Conv`` in the dense and SD modes are ported and build), and a
    sparse-output max pooling."""
    mlp = {**MLPD, "numlayer": 1, "tailact": True}
    for mode in ("DD", "SD"):
        conv = pt_conv.I2Conv(8, 8, "sum", mode, mlp, **GEN)
        assert type(conv.aggr.mod).__name__.endswith("OnSubg3D")
        with pytest.raises(NotImplementedError, match="I2GNN"):
            make_ma_model("I2GNN", num_layer=1, hiddim=8, mode=mode,
                          device="cpu")
    assert pt_tensorop.OpPoolingSubg3D("D").mod.dims == [3]
    with pytest.raises(NotImplementedError, match="max"):
        pt_op.OpPoolingSubg3D("max")
