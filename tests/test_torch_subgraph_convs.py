"""The subgraph conv family in sparse mode (SSWL, DSSGNN, GNNAK, SUN and
PPGN-SS) against the JAX package, on the CPU, up to the layer: the
``SparseTensor`` methods and operators under them (with ``PAD_INDEX``
padding rows present, holding values that must not leak), ``spmm``,
``HeteroLinear``, the gradients of K1's cross-subgraph and 2-FWL
contractions and each conv's layer output, with the JAX weights carried
across by ``weights.load_jax_params``; and what stays unported.  The
models, their gradients and their training:
``tests/test_torch_subgraph_models.py``.

Sizes are small (2 layers, D <= 32, a few ``synthetic_zinc`` graphs);
inputs and norm statistics come from numpy seeds.  Each test states its
tolerance; all of them compare f32 on both sides, with sums taken in
other orders.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.backend.spmm import spmm as jx_spmm
from pygho_tpu.backend.spspmm import spspmm as jx_spspmm
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.honn import sp_operator as jx_op
from pygho_tpu.honn import utils as jx_utils

from pygho_tpu_torch.backend.spmm import spmm
from pygho_tpu_torch.backend.spspmm import spspmm
from pygho_tpu_torch.hodata.loader import add_rowptr
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn import parse_precomputekey
from pygho_tpu_torch.honn import sp_operator as pt_op
from pygho_tpu_torch.honn import utils as pt_utils
from pygho_tpu_torch.honn.sp_operator import fetch_backward_orders
from pygho_tpu_torch.models import make_sp_model
from pygho_tpu_torch.weights import load_jax_params

SUB = "X___X___1___A___0"
CROSS = "X___A___1___X___0"
FWL = "X___X___1___X___0"
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
CPU = torch.device("cpu")
GEN = dict(generator=torch.Generator().manual_seed(0))
# the value left in padding rows: large enough that a leak shows
GARBAGE = 1e3


def _batch(keys, n_graphs=6, pad_to=8):
    """One collated batch of ``synthetic_zinc("val")`` graphs at hop 3,
    with padded tuples, edges and triples."""
    pre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=n_graphs)]
    return jx_collate_sparse(datas, keys, [""], pad_to)


def _dicts(batch, keys):
    """The JAX datadict and the port's (with the row pointers and the
    backward orders) of one batch."""
    pb = dict(batch)
    add_rowptr(pb, keys, backward=True)
    return jx_to_dict(batch), batch_to_sparse_dict(pb, ("",), CPU)


def _values(rng, rows, real, D):
    """``(rows, D)`` f32 values, normal in the real rows and
    ``GARBAGE`` in the padding rows."""
    v = np.full((rows, D), GARBAGE, np.float32)
    v[:real] = rng.normal(size=(real, D))
    return v


def _with(T, v):
    """The SparseTensor ``T`` (JAX or port) with values ``v`` (numpy)."""
    conv = jnp.asarray if type(T).__module__.startswith("pygho_tpu.") \
        else torch.from_numpy
    return dataclasses.replace(T, values=conv(np.ascontiguousarray(v)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def jax_params(module):
    """The JAX module's state flattened to numpy arrays by path."""
    return {path: np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(module))}


def randomize_bn(module, rng):
    """Seeded, non-identity BatchNorm parameters and statistics."""
    for _, mod in nnx.iter_graph(module):
        if isinstance(mod, jx_utils.BatchNorm):
            d = mod.num_features
            mod.mean[...] = jnp.asarray(rng.normal(0, 0.5, d), jnp.float32)
            mod.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, d), jnp.float32)
            mod.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, d),
                                         jnp.float32)
            mod.bias[...] = jnp.asarray(rng.normal(0, 0.2, d), jnp.float32)


def _port_name(path):
    dotted = ".".join(str(p) for p in path)
    prefix, _, leaf = dotted.rpartition(".")
    if leaf in ("kernel", "embedding"):
        return f"{prefix}.weight", leaf == "kernel"
    return dotted, False


def bn_fed_biases(model):
    """Names of the Linear biases that feed a BatchNorm, and of the
    running means of those norms: in training mode their gradients are 0
    in exact arithmetic (the norm subtracts the batch mean), so what each
    side computes for them is rounding noise."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, pt_utils.MLP):
            for i in range(len(mod.hid_lins)):
                names |= {f"{prefix}.hid_lins.{i}.bias",
                          f"{prefix}.hid_norms.{i}.mean"}
            if mod.tail_lin is not None and mod.tailact:
                names |= {f"{prefix}.tail_lin.bias",
                          f"{prefix}.tail_norm.mean"}
    return names


def maxrel(x, ref):
    """Largest difference over the largest magnitude of the reference."""
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.abs(x - ref).max()) / (float(np.abs(ref).max()) + 1e-9)


# ---------------------------------------------------------------------------
# SparseTensor methods, spmm and HeteroLinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["sum0", "mean0", "mean1", "diag",
                                    "unpool0", "unpool1", "catvalue",
                                    "diagonalapply"])
def test_sparse_tensor_method_matches_jax(rng, method):
    """Each ported ``SparseTensor`` method against JAX's on a batch whose
    tuples and nodes have padding rows, the padding rows of the values
    holding ``GARBAGE``: the reductions over dim 0 (unsorted ids) and dim
    1, the dense diagonal, the unpooling from a dense tensor (gathers at
    ``PAD_INDEX`` clamp, as JAX's), ``catvalue`` and ``diagonalapply``.
    Tolerance 1e-5 abs (sums of a few values of order 1), and the padding
    rows of every tuple-shaped result exactly 0 where JAX re-zeroes them
    (the unpooling and ``diagonalapply``)."""
    D = 5
    jd, pd = _dicts(_batch([SUB]), [SUB])
    nt, nt_pad = pd["X"].nnz, pd["X"].nnz_pad
    n_pad = pd["x"].shape[0]
    assert nt < nt_pad and int(pd["num_nodes"]) < n_pad
    v = _values(rng, nt_pad, nt, D)
    jX, pX = _with(jd["X"], v), _with(pd["X"], v)
    dense = rng.normal(size=(n_pad, D)).astype(np.float32)
    if method == "sum0":
        ref, out = jX.sum([0]), pX.sum([0])
    elif method == "mean0":
        ref, out = jX.mean([0]), pX.mean([0])
    elif method == "mean1":
        ref, out = jX.mean([1]), pX.mean([1])
    elif method == "diag":
        ref, out = jX.diag([0, 1]), pX.diag([0, 1])
        assert np.any(_np(ref) != 0)
    elif method.startswith("unpool"):
        d = int(method[-1])
        ref = jX.unpooling_fromdense1dim(d, jnp.asarray(dense)).values
        out = pX.unpooling_fromdense1dim(d, torch.from_numpy(dense)).values
        assert np.all(_np(out)[nt:] == 0)
    elif method == "catvalue":
        w = _values(rng, nt_pad, nt, 3)
        ref = jX.catvalue([_with(jd["X"], w), jX], True).values
        out = pX.catvalue([_with(pd["X"], w), pX], True).values
    else:
        ref = jX.diagonalapply(lambda x, t: x * (1.0 + t[:, None])).values
        out = pX.diagonalapply(lambda x, t: x * (1.0 + t[:, None])).values
        assert np.all(_np(out)[nt:] == 0)
    assert _np(out).shape == _np(ref).shape
    assert np.abs(_np(out) - _np(ref)).max() < 1e-5


@pytest.mark.parametrize("dim1", [0, 1])
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_spmm_matches_jax(rng, dim1, aggr):
    """``spmm`` against JAX's on the batch's adjacency, whose padding
    edges hold ``GARBAGE`` values and ``PAD_INDEX`` indices (the source
    gather clamps, the padded targets drop out).  Tolerance 1e-5 abs."""
    D = 6
    jd, pd = _dicts(_batch([SUB]), [SUB])
    ne, ne_pad = pd["A"].nnz, pd["A"].nnz_pad
    assert ne < ne_pad
    v = _values(rng, ne_pad, ne, D)
    X = rng.normal(size=(pd["x"].shape[0], D)).astype(np.float32)
    ref = jx_spmm(_with(jd["A"], v), dim1, jnp.asarray(X), aggr)
    out = spmm(_with(pd["A"], v), dim1, torch.from_numpy(X), aggr)
    assert np.abs(_np(out) - _np(ref)).max() < 1e-5


@pytest.mark.parametrize("use_bias", [False, True])
def test_heterolinear_matches_jax(rng, use_bias):
    """``HeteroLinear`` with the JAX weights carried across (the weight
    copied as it is, ``(num_types, in, out)``), on random types, and its
    input gradient.  Tolerance 1e-5 abs on outputs of order 1 (two
    products of 24 terms)."""
    jl = jx_utils.HeteroLinear(24, 8, 2, use_bias, rngs=nnx.Rngs(3))
    if use_bias:
        jl.bias[...] = jnp.asarray(rng.normal(size=(2, 8)), jnp.float32)
    pl = pt_utils.HeteroLinear(24, 8, 2, use_bias, **GEN)
    load_jax_params(pl, jax_params(jl))
    assert torch.equal(pl.weight, torch.tensor(np.asarray(jl.weight[...])))
    x = rng.normal(size=(50, 24)).astype(np.float32)
    t = rng.integers(0, 2, 50).astype(np.int32)
    w = rng.normal(size=(50, 8)).astype(np.float32)
    ref, jg = jax.value_and_grad(
        lambda x: (jl(x, jnp.asarray(t)) * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = pl(xt, torch.from_numpy(t))
    (out * torch.from_numpy(w)).sum().backward()
    assert np.abs(_np(out) - np.asarray(jl(jnp.asarray(x),
                                           jnp.asarray(t)))).max() < 1e-5
    assert np.abs(xt.grad.numpy() - np.asarray(jg)).max() < 1e-5


# ---------------------------------------------------------------------------
# operators and K1's new contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["node_mp", "cross", "2fwl", "diag2d",
                                "pool_cross", "unpool_subg", "unpool_root"])
def test_operator_matches_jax(rng, op):
    """Each new operator against JAX's on one batch with padding rows
    holding ``GARBAGE``: ``OpNodeMessagePassing`` (``spmm``), the
    cross-subgraph message passing and ``Op2FWL`` (K1's plain version on
    the loader's triples, against JAX's XLA contraction on the padded
    ones), ``OpDiag2D``, ``OpPoolingCrossSubg2D`` (mean) and the two
    unpoolings.  Tolerance 1e-5 abs on sums of tens of products of values
    of order 1, and every padding row of a tuple-shaped result 0."""
    D = 8
    keys = [CROSS, FWL, SUB]
    jd, pd = _dicts(_batch(keys), keys)
    nt, nt_pad = pd["X"].nnz, pd["X"].nnz_pad
    ne, ne_pad = pd["A"].nnz, pd["A"].nnz_pad
    n_pad = pd["x"].shape[0]
    xv, av = _values(rng, nt_pad, nt, D), _values(rng, ne_pad, ne, D)
    xv[nt:] = 0          # the model's tuple values: padding rows are 0
    jX, pX = _with(jd["X"], xv), _with(pd["X"], xv)
    jA, pA = _with(jd["A"], av), _with(pd["A"], av)
    dense = rng.normal(size=(n_pad, D)).astype(np.float32)
    jdense, pdense = jnp.asarray(dense), torch.from_numpy(dense)
    if op == "node_mp":
        ref = jx_op.OpNodeMessagePassing("sum")(jA, jdense)
        out = pt_op.OpNodeMessagePassing("sum")(pA, pdense)
    elif op == "cross":
        ref = jx_op.OpMessagePassingCrossSubg2D()(jA, jX, jd, jX).values
        out = pt_op.OpMessagePassingCrossSubg2D()(pA, pX, pd, pX).values
    elif op == "2fwl":
        xv2 = _values(rng, nt_pad, nt, D)
        xv2[nt:] = 0
        ref = jx_op.Op2FWL()(jX, _with(jd["X"], xv2), jd, jX).values
        out = pt_op.Op2FWL()(pX, _with(pd["X"], xv2), pd, pX).values
    elif op == "diag2d":
        ref, out = jx_op.OpDiag2D()(jX), pt_op.OpDiag2D()(pX)
    elif op == "pool_cross":
        ref = jx_op.OpPoolingCrossSubg2D("mean")(jX)
        out = pt_op.OpPoolingCrossSubg2D("mean")(pX)
    elif op == "unpool_subg":
        ref = jx_op.OpUnpoolingSubgNodes2D()(jdense, jX).values
        out = pt_op.OpUnpoolingSubgNodes2D()(pdense, pX).values
    else:
        ref = jx_op.OpUnpoolingRootNodes2D()(jdense, jX).values
        out = pt_op.OpUnpoolingRootNodes2D()(pdense, pX).values
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    assert np.abs(out - ref).max() < 1e-5
    if out.shape[0] == nt_pad:
        assert np.all(out[nt:] == 0)


@pytest.mark.parametrize("key", [CROSS, FWL])
def test_contraction_grads_match_jax(rng, key):
    """The cross-subgraph key (the edge values as K1's first operand,
    their gradient from the dX role over the loader's ``c`` order on the
    padded edge rows) and the 2-FWL key (both operands tuple values):
    ``spspmm``'s value and both operands' gradients (``SpspmmSum``'s dX
    and dA roles) against ``jax.vjp`` of JAX's ``spspmm`` for a random
    cotangent.  Tolerance 1e-4 abs on sums of up to hundreds of products
    of values of order 1."""
    D = 16
    jd, pd = _dicts(_batch([key]), [key])
    nt, nt_pad = pd["X"].nnz, pd["X"].nnz_pad
    ne, ne_pad = pd["A"].nnz, pd["A"].nnz_pad
    first = ("A", ne, ne_pad) if key == CROSS else ("X", nt, nt_pad)
    U = np.zeros((first[2], D), np.float32)
    U[:first[1]] = rng.normal(size=(first[1], D))
    V = np.zeros((nt_pad, D), np.float32)
    V[:nt] = rng.normal(size=(nt, D))
    W = rng.normal(size=(nt_pad, D)).astype(np.float32)
    acd = jnp.asarray(jd[f"{key}___acd"])

    def f(u, v):
        return jx_spspmm(dataclasses.replace(jd[first[0]], values=u), 1,
                         dataclasses.replace(jd["X"], values=v), 0, "sum",
                         acd=acd, tarX=jd["X"]).values

    ref, vjp = jax.vjp(f, jnp.asarray(U), jnp.asarray(V))
    gu, gv = vjp(jnp.asarray(W))
    Ut = torch.from_numpy(U).requires_grad_()
    Vt = torch.from_numpy(V).requires_grad_()
    out = spspmm(dataclasses.replace(pd[first[0]], values=Ut), 1,
                 dataclasses.replace(pd["X"], values=Vt), 0, "sum",
                 acd=pd[f"{key}___acd"], rowptr=pd[f"{key}___rowptr"],
                 tarX=pd["X"], bwd=fetch_backward_orders(pd, key)).values
    (out * torch.from_numpy(W)).sum().backward()
    assert pd[f"{key}___rowptr_dx"].shape[0] == first[2] + 1
    for got, want in ((out, ref), (Ut.grad, gu), (Vt.grad, gv)):
        got, want = _np(got), np.asarray(want)
        assert got.shape == want.shape and np.abs(want).max() > 0.1
        assert np.abs(got - want).max() < 1e-4


# ---------------------------------------------------------------------------
# the convs
# ---------------------------------------------------------------------------

def _conv_pair(name, D, mlp):
    """A JAX conv and the port's, the port's built from a generator: the
    weights are carried across by the caller."""
    conv, kw = name, {}
    if name.startswith("GNNAK"):
        conv, kw = "GNNAK", {"ctx": name == "GNNAK"}
    args = {"SSWL": (D, D, "sum", "SS", mlp),
            "DSSGNN": (D, D, "sum", "sum", "mean", "SS", mlp),
            "GNNAK": (D, D, "sum", "mean", "SS", mlp, mlp),
            "SUN": (D, D, "sum", "mean", "SS", mlp, mlp),
            "PPGN": (D, D, "sum", "SS", mlp)}[conv]
    jc = getattr(jx_conv, f"{conv}Conv")(*args, **kw, rngs=nnx.Rngs(2))
    pc = getattr(pt_conv, f"{conv}Conv")(*args, **kw, **GEN)
    return jc, pc


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["SSWL", "DSSGNN", "GNNAK", "GNNAK-noctx",
                                  "SUN", "PPGN"])
def test_conv_layer_matches_jax(rng, name, train):
    """One layer of each conv (GNNAK with and without ``ctx``) on the
    batch's tuple and edge values, with seeded non-identity BatchNorm
    statistics, in eval and training mode.  Tolerance 2e-5 abs on outputs
    of order 1 (SUN's 7 x D-wide concatenation and two-layer MLPs sum up
    to 224 products a value), and the padding rows exactly 0."""
    D = 32
    mlp = {**MLPD, "numlayer": 2, "tailact": True}
    jc, pc = _conv_pair(name, D, mlp)
    randomize_bn(jc, rng)
    load_jax_params(pc, jax_params(jc))
    (jc.train if train else jc.eval)()
    pc.train(train)
    keys = parse_precomputekey(pc)
    assert keys == jx_keys(jc)
    jd, pd = _dicts(_batch(keys), keys)
    nt, ne = pd["X"].nnz, pd["A"].nnz
    xv = np.zeros((pd["X"].nnz_pad, D), np.float32)
    xv[:nt] = rng.normal(size=(nt, D))
    av = np.zeros((pd["A"].nnz_pad, D), np.float32)
    av[:ne] = rng.normal(size=(ne, D))
    ref = np.asarray(jc(_with(jd["A"], av), _with(jd["X"], xv), jd).values)
    out = pc(_with(pd["A"], av), _with(pd["X"], xv), pd).values
    out = out.detach().numpy()
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    assert np.abs(out - ref).max() < 2e-5
    assert np.all(out[nt:] == 0)


def test_what_stays_unported_raises():
    """Sparse I2GNN (the 3-tuple path, ``ROADMAP.md`` Queue A item 7) and
    the dense and SD modes of the new convs (item 9) raise
    ``NotImplementedError``; so do a sparse-output diagonal and unpooling
    a SparseTensor."""
    with pytest.raises(NotImplementedError, match="I2GNN"):
        make_sp_model("I2GNN", num_layer=1, hiddim=8, device="cpu")
    mlp = {**MLPD, "numlayer": 1, "tailact": True}
    for mode in ("DD", "SD"):
        with pytest.raises(NotImplementedError, match="item 9"):
            pt_conv.SSWLConv(8, 8, "sum", mode, mlp, **GEN)
    with pytest.raises(NotImplementedError, match="item 9"):
        pt_conv.SUNConv(8, 8, "sum", "mean", "DD", mlp, mlp, **GEN)
    with pytest.raises(NotImplementedError):
        pt_op.OpDiag([0, 1], return_sparse=True)
    with pytest.raises(NotImplementedError):
        pt_op.OpUnpoolingSubgNodes2D()(pt_op.SparseTensor(
            torch.zeros(2, 1, dtype=torch.long), None, 1, (2, 2)), None)
