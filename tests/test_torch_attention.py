"""The NGAT slice of the port against the JAX package, on the CPU: the
segment reductions and the segment softmax, K4 (``SegmentAttention``,
whose roles run their plain versions here, on the same host orders the
card's kernels read) against the TPU kernel ``fused_attention_strip`` in
interpret mode and against a segment-softmax oracle, the flush regime
where the two kernels part, ``NGATConv``, ``SpModel("NGAT")``,
``SpPredictor`` and a ten-step training trajectory with the JAX weights
carried across, and the refusals.

Every input comes from a numpy seed; each test states its tolerance."""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.backend import segment as jx_segment
from pygho_tpu.backend.indexing import PAD_INDEX
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.honn import utils as jx_utils
from pygho_tpu.kernels.strip_attention import (build_attention_strip_plans,
                                               fused_attention_strip)
from pygho_tpu.models import SpPredictor as JxSpPredictor
from pygho_tpu.models import make_sp_model as jx_make_sp_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.backend import segment as pt_segment
from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.hodata.loader import add_rowptr, backward_orders
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn import parse_precomputekey
from pygho_tpu_torch.kernels import segment_attention as k4
from pygho_tpu_torch.kernels.segment_attention import SegmentAttention
from pygho_tpu_torch.models import SpPredictor, make_sp_model, training
from pygho_tpu_torch.weights import load_jax_params

KEY = "X___X___1___A___0"
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
MLP1 = {**MLPD, "numlayer": 1, "tailact": True}   # SpModel's defaults
GEN = dict(generator=torch.Generator().manual_seed(0))


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
    """Names of the Linear biases whose gradient is 0 in exact arithmetic
    in training mode, and of the running means they shift: a bias that
    feeds a BatchNorm (the norm subtracts the batch mean), and NGAT's
    ``att3`` bias, which the softmax adds whole (the weights sum to 1) to
    every row with triples, where the next MLP's or the pooling MLP's
    BatchNorm takes it out again.  Their gradients are rounding noise."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, pt_conv.MLP):
            for i in range(len(mod.hid_lins)):
                names |= {f"{prefix}.hid_lins.{i}.bias",
                          f"{prefix}.hid_norms.{i}.mean"}
            if mod.tail_lin is not None and mod.tailact:
                names |= {f"{prefix}.tail_lin.bias",
                          f"{prefix}.tail_norm.mean"}
        if isinstance(mod, pt_conv.NGATConv) and prefix:
            names.add(f"{prefix}.att3.bias")
    return names


def maxrel(x, ref):
    """Largest difference over the largest magnitude of the reference."""
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.abs(x - ref).max()) / (float(np.abs(ref).max()) + 1e-9)


# ---------------------------------------------------------------------------
# segment reductions and the segment softmax
# ---------------------------------------------------------------------------


def _segments(rng, n=400, segs=60, D=7):
    """Sorted ids with empty segments and PAD_INDEX padding."""
    ids = np.sort(rng.integers(0, segs, n))
    ids = ids[(ids % 7) != 3]                 # some empty segments
    ids = np.concatenate([ids, np.full(13, PAD_INDEX)])
    src = rng.normal(0, 3, size=(ids.size, D)).astype(np.float32)
    return src, ids.astype(np.int64), segs


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_segment_reduce_max_min_match_jax(rng, aggr):
    """Exact: a maximum or minimum is one of its inputs, in any order;
    empty segments give 0, PAD ids are dropped."""
    src, ids, segs = _segments(rng)
    ref = np.asarray(jx_segment.segment_reduce(
        jnp.asarray(src), jnp.asarray(ids, jnp.int32), segs, aggr))
    got = pt_segment.segment_reduce(torch.from_numpy(src),
                                    torch.from_numpy(ids), segs, aggr)
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)
    empty = np.bincount(ids[ids < segs], minlength=segs) == 0
    assert empty.any() and np.all(got.numpy()[empty] == 0)
    with pytest.raises(ValueError, match="unknown aggr"):
        pt_segment.segment_reduce(torch.from_numpy(src),
                                  torch.from_numpy(ids), segs, "prod")


@pytest.mark.parametrize("stable", ["segment", "global"])
def test_segment_softmax_matches_jax(rng, stable):
    """Both shifts, rows with PAD ids included (JAX clamps their gathers
    to the last segment, here an empty one, so those rows are exp(src) /
    1e-16).  Tolerance 1e-6 of max(1, |weight|): one exp and one f32 sum
    of a few terms, in another order."""
    src, ids, segs = _segments(rng)
    ref = np.asarray(jx_segment.segment_softmax(
        jnp.asarray(src), jnp.asarray(ids, jnp.int32), segs, stable=stable))
    got = pt_segment.segment_softmax(torch.from_numpy(src),
                                     torch.from_numpy(ids), segs,
                                     stable=stable).numpy()
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1, np.abs(ref)))
    real = ids < segs
    sums = pt_segment.segment_reduce(torch.from_numpy(got[real]),
                                     torch.from_numpy(ids[real]), segs)
    nonempty = np.bincount(ids[real], minlength=segs) > 0
    assert np.abs(sums.numpy()[nonempty] - 1).max() < 1e-6


# ---------------------------------------------------------------------------
# K4 against the TPU kernel and the oracle
# ---------------------------------------------------------------------------


def _att_inputs(rng, x_rows=300, e_rows=200, D=128, K=900, scale=1.0):
    """``tests/test_kernels.py``'s attention case: K triples sorted by a,
    the single-launch strip plans over them (padded to 1,024), and the
    four operands ``(a1, a3, aA, a2)``."""
    a = np.sort(rng.integers(0, x_rows, K))
    c = rng.integers(0, x_rows, K)
    d = rng.integers(0, e_rows, K)
    acd = np.stack([a, c, d])
    padded = np.full((3, 1024), PAD_INDEX, np.int64)
    padded[:, :K] = acd
    geoms = {r: (64, 128, 256, 128, 128, 1) for r in ("fwd", "dx", "da")}
    plans = build_attention_strip_plans(padded, x_rows, e_rows, geoms)
    ops = tuple((scale * rng.standard_normal((n, D))).astype(np.float32)
                for n in (x_rows, x_rows, e_rows, x_rows))
    return acd, plans, ops


def _att_oracle(a, c, d, x_rows):
    """The JAX package's unfused arithmetic: segment max, exp, segment
    sums (``tests/test_kernels.py``'s ``_att_oracle``)."""
    def oracle(a1, a3, aA, a2):
        s = a1[c] * aA[d] * a2[a]
        m = jax.ops.segment_max(s, a, x_rows)
        e = jnp.exp(s - m[a])
        den = jax.ops.segment_sum(e, a, x_rows)
        num = jax.ops.segment_sum(e * a3[c], a, x_rows)
        return num / jnp.maximum(den, 1e-30)
    return oracle


def _port_att(acd, ops, w):
    """The port's forward and its four gradients for cotangent ``w``."""
    x_rows, e_rows = ops[0].shape[0], ops[2].shape[0]
    acd32 = torch.from_numpy(acd.astype(np.int32))
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(acd[0], minlength=x_rows))])
        .astype(np.int32))
    orders = backward_orders(acd, x_rows, e_rows)
    bwd = tuple(torch.from_numpy(x) for role in ("dx", "da")
                for x in orders[role])
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in ops]
    out = SegmentAttention.apply(*ts, acd32, rowptr, bwd)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_vjp(f, ops, w):
    args = tuple(jnp.asarray(x) for x in ops)
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def test_k4_matches_the_tpu_kernel(rng):
    """Forward and all four gradients against ``fused_attention_strip``
    in interpret mode, exact math, at scale 1 (where it does not flush).
    Tolerance 2e-4, the JAX package's own bound for that kernel against
    its oracle: abs on the forward, relative to the largest entry on each
    gradient."""
    acd, plans, ops = _att_inputs(rng)
    x_rows = ops[0].shape[0]
    w = rng.standard_normal((x_rows, 128)).astype(np.float32)
    ref, ref_g = _jax_vjp(lambda *o: fused_attention_strip(
        *o, *plans, None, True, True)[:x_rows], ops, w)
    out, grads = _port_att(acd, ops, w)
    assert np.abs(out - ref).max() < 2e-4
    for name, g, r in zip(("a1", "a3", "aA", "a2"), grads, ref_g):
        assert maxrel(g, r) < 2e-4, name
        assert np.abs(r).max() > 0.1, name       # not vacuous


@pytest.mark.parametrize("D", [128, 13])
def test_k4_matches_the_segment_softmax_oracle(rng, D):
    """Forward and all four gradients against the segment-softmax oracle
    (JAX autodiff through it), D = 128 and D = 13.  Tolerance 1e-5: abs on
    the forward (outputs of order 1), relative to the largest entry on
    each gradient; the same f32 arithmetic with sums in another order."""
    acd, _, ops = _att_inputs(rng, D=D)
    x_rows = ops[0].shape[0]
    w = rng.standard_normal((x_rows, D)).astype(np.float32)
    ref, ref_g = _jax_vjp(_att_oracle(*acd, x_rows), ops, w)
    out, grads = _port_att(acd, ops, w)
    assert np.abs(out - ref).max() < 1e-5
    for name, g, r in zip(("a1", "a3", "aA", "a2"), grads, ref_g):
        assert maxrel(g, r) < 1e-5, name
    empty = np.bincount(acd[0], minlength=x_rows) == 0
    assert empty.any() and np.all(out[empty] == 0)


def test_k4_stays_finite_where_the_tpu_kernel_flushes(rng):
    """Scores scaled 3x: the TPU kernel's bound shift overshoots and, with
    its ``nonempty`` mask in poison mode, returns NaN on the rows it
    flushes (0 without the mask).  The port shifts each row by its exact
    maximum, so every row stays finite and equals the oracle, forward and
    gradients.  Tolerance 1e-5 relative to the largest entry."""
    acd, plans, ops = _att_inputs(rng, scale=3.0)
    x_rows = ops[0].shape[0]
    nonempty = np.bincount(acd[0], minlength=x_rows) > 0
    tpu = np.asarray(fused_attention_strip(
        *(jnp.asarray(x) for x in ops), *plans, jnp.asarray(nonempty),
        True, True, True)[:x_rows])
    flushed = np.isnan(tpu).any(axis=1)
    assert flushed.any()
    w = rng.standard_normal((x_rows, 128)).astype(np.float32)
    ref, ref_g = _jax_vjp(_att_oracle(*acd, x_rows), ops, w)
    out, grads = _port_att(acd, ops, w)
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    assert maxrel(out, ref) < 1e-5
    assert maxrel(out[flushed], ref[flushed]) < 1e-5
    for name, g, r in zip(("a1", "a3", "aA", "a2"), grads, ref_g):
        assert np.isfinite(g).all() and maxrel(g, r) < 1e-5, name


def test_k4_backward_runs_only_the_roles_it_needs(rng, monkeypatch):
    """``needs_input_grad`` skips a role (dc serves a1 and a3); a backward
    with no backward orders raises instead of dropping the gradient."""
    acd, _, ops = _att_inputs(rng, x_rows=20, e_rows=10, D=8, K=60)
    acd32 = torch.from_numpy(acd.astype(np.int32))
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(acd[0], minlength=20))])
        .astype(np.int32))
    orders = backward_orders(acd, 20, 10)
    bwd = tuple(torch.from_numpy(x) for role in ("dx", "da")
                for x in orders[role])
    calls = []
    real = k4.attend

    def spy(role, *args):
        calls.append(role.NAME)
        return real(role, *args)

    monkeypatch.setattr(k4, "attend", spy)
    for which, roles in ((0, [k4.FWD, k4.DC]), (1, [k4.FWD, k4.DC]),
                         (2, [k4.FWD, k4.DV]), (3, [k4.FWD, k4.DW])):
        ts = [torch.from_numpy(x.copy()) for x in ops]
        ts[which].requires_grad_()
        calls.clear()
        SegmentAttention.apply(*ts, acd32, rowptr, bwd).sum().backward()
        assert calls == [r.NAME for r in roles]
        assert ts[which].grad is not None
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in ops]
    out = SegmentAttention.apply(*ts, acd32, rowptr, None)
    with pytest.raises(RuntimeError, match="backward=True"):
        out.sum().backward()
    with pytest.raises(ValueError, match="backward row pointers"):
        SegmentAttention.apply(*ts, acd32, rowptr, bwd[::-1])


def test_k4_raw_wrapper_refuses(rng):
    """The raw wrapper refuses a tensor that requires grad (it builds no
    graph), other dtypes, mismatched shapes and row pointers, and a
    gradient role without its inputs; under ``no_grad`` it runs."""
    acd, _, ops = _att_inputs(rng, x_rows=20, e_rows=10, D=8, K=60)
    acd32 = torch.from_numpy(acd.astype(np.int32))
    rowptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(acd[0], minlength=20))])
        .astype(np.int32))
    ts = [torch.from_numpy(x.copy()) for x in ops]
    for i in range(4):
        bad = list(ts)
        bad[i] = bad[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="SegmentAttention"):
            k4.attend(k4.FWD, *bad, acd32, rowptr)
        with torch.no_grad():
            k4.attend(k4.FWD, *bad, acd32, rowptr)
    with pytest.raises(TypeError, match="float32"):
        k4.attend(k4.FWD, ts[0].double(), *ts[1:], acd32, rowptr)
    with pytest.raises(ValueError, match="rowptr"):
        k4.attend(k4.FWD, *ts, acd32, rowptr[:-1])
    with pytest.raises(ValueError, match="rowptr"):
        k4.attend(k4.DV, *ts, acd32, rowptr, ts[0], ts[1], ts[3])
    with pytest.raises(ValueError, match="needs M"):
        k4.attend(k4.DW, *ts, acd32, rowptr)
    with pytest.raises(ValueError, match="x_rows, D"):
        k4.attend(k4.FWD, ts[0][:, :4].contiguous(), *ts[1:], acd32,
                  rowptr)
    with pytest.raises(ValueError, match="does not cover"):
        k4.attend(k4.FWD, *ts, acd32[:, :-1].contiguous(), rowptr)


# ---------------------------------------------------------------------------
# the layer, the model, the predictor and training against JAX
# ---------------------------------------------------------------------------


def _sparse_batch(n_graphs, hop=3):
    pre = JxSppretransform(partial(JxKhopSampler, hop=hop), [""], [KEY])
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=n_graphs)]
    return jx_collate_sparse(datas, [KEY], [""], n_graphs + 2)


@pytest.mark.parametrize("train", [False, True])
def test_ngatconv_matches_jax_unfused(rng, train):
    """``NGATConv`` at D = 16 against the JAX layer's unfused path
    (``spspmpnn`` + ``segment_softmax``), forward and the gradients of
    its inputs and of every parameter.  Tolerance 1e-5: abs on the
    forward, relative to the largest entry on each gradient."""
    D = 16
    batch = _sparse_batch(6, hop=2)
    nt, ne = int(batch["num_tuples"]), int(batch["num_edges"])
    U = np.zeros((batch["tupleid"].shape[1], D), np.float32)
    V = np.zeros((batch["edge_index"].shape[1], D), np.float32)
    U[:nt] = rng.normal(size=(nt, D))
    V[:ne] = rng.normal(size=(ne, D))
    W = rng.normal(size=U.shape).astype(np.float32)

    jc = jx_conv.NGATConv(D, D, "sum", "SS", MLP1, rngs=nnx.Rngs(2))
    randomize_bn(jc, rng)
    pc = pt_conv.NGATConv(D, D, "sum", "SS", MLP1, **GEN)
    load_jax_params(pc, jax_params(jc))
    (jc.train if train else jc.eval)()
    pc.train(train)

    jd = jx_to_dict(batch)
    graphdef, state = nnx.split(jc)

    def jloss(state, u, v):
        X = jd["X"].__class__(jd["X"].indices, u, jd["X"].nnz,
                              jd["X"].sparse_shape)
        A = jd["A"].__class__(jd["A"].indices, v, jd["A"].nnz,
                              jd["A"].sparse_shape)
        out = nnx.merge(graphdef, state)(A, X, jd).values
        return jnp.sum(out * jnp.asarray(W)), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        state, jnp.asarray(U), jnp.asarray(V))

    pb = copy.deepcopy(batch)
    add_rowptr(pb, [KEY], backward=True)
    pd = batch_to_sparse_dict(pb, ("",), torch.device("cpu"))
    Ut = torch.from_numpy(U).requires_grad_()
    Vt = torch.from_numpy(V).requires_grad_()
    pX = SparseTensor(pd["X"].indices, Ut, pd["X"].nnz, pd["X"].sparse_shape)
    pA = SparseTensor(pd["A"].indices, Vt, pd["A"].nnz, pd["A"].sparse_shape)
    out = pc(pA, pX, pd).values
    (out * torch.from_numpy(W)).sum().backward()
    out = out.detach().numpy()
    assert out.shape == ref.shape
    assert np.abs(out - np.asarray(ref)).max() < 1e-5
    assert np.all(out[nt:] == 0)
    assert maxrel(Ut.grad.numpy(), jg[1]) < 1e-5
    assert maxrel(Vt.grad.numpy(), jg[2]) < 1e-5
    params = dict(pc.named_parameters())
    noisy = bn_fed_biases(pc) if train else set()
    for path, g in nnx.to_flat_state(jg[0]):
        name, transpose = _port_name(path)
        if name not in params:             # BatchNorm statistics
            continue
        g = np.asarray(g.get_value())
        got = params.pop(name).grad.numpy()
        if name not in noisy:
            assert np.abs(g).max() > 1e-3, name
            assert maxrel(got, g.T if transpose else g) < 1e-5, name
    assert not params


def _jax_model(num_layer, hiddim, mlp=MLPD):
    jm = jx_make_sp_model("NGAT", num_layer=num_layer, hiddim=hiddim,
                          mlp=dict(mlp))
    return jm, jx_keys(jm)


def _port_model(jm, num_layer, hiddim, mlp=MLPD):
    pm = make_sp_model("NGAT", num_layer=num_layer, hiddim=hiddim,
                       mlp=dict(mlp), device="cpu")
    load_jax_params(pm, jax_params(jm))
    return pm


def test_ngat_state_maps_onto_the_port():
    """Every path of the JAX NGAT state has a counterpart in the port's
    model and none of the port's is left unset (``load_jax_params``
    raises otherwise); the key is the one the layer reads."""
    jm, keys = _jax_model(2, 8)
    pm = _port_model(jm, 2, 8)
    assert parse_precomputekey(pm) == keys == [KEY]
    flat = jax_params(jm)
    assert any("attA" in str(p) for p in flat)
    w = flat[("subggnns", 1, "att3", "kernel")]
    assert torch.equal(pm.subggnns[1].att3.weight, torch.tensor(w.T))
    assert len(flat) == len(dict(pm.named_parameters())) \
        + len(dict(pm.named_buffers()))


def test_ngat_model_matches_jax_single_launch(rng):
    """``SpModel("NGAT")`` 2x128 in training mode against the JAX model on
    its single-launch path (``fused_attention_strip`` in interpret mode,
    on the loader's attention plans), predictions and the gradients of
    every parameter.  Tolerance: 1e-4 abs on predictions of order 1 (f32
    through two layers and the readout, sums in another order) and 2e-4
    relative to each gradient's largest entry (the JAX package's bound
    for that kernel)."""
    jm, keys = _jax_model(2, 128)
    pm = _port_model(jm, 2, 128)
    jm.train()
    pm.train()
    jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    jdatas = [jpre(g) for g in jx_synthetic_zinc("train", 4)]
    jb = next(iter(JxSpDataloader(jdatas, 4, keys, device_put=False,
                                  prefetch=0, attention_plans=True,
                                  plan_dim=128)))
    assert f"{KEY}___attplan1" in jb
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], keys)
    pb = next(iter(SpDataloader([pre(g) for g in synthetic_zinc("train", 4)],
                                4, keys, backward=True)))
    graphdef, state = nnx.split(jm)

    def jloss(state):
        pred = nnx.merge(graphdef, state)(jx_to_dict(jb))
        return jx_training.masked_l1_loss(
            pred, jnp.asarray(jb["y"]), jnp.asarray(jb["graph_mask"])), pred

    (_, jpred), jg = jax.value_and_grad(jloss, has_aux=True)(state)
    dd = batch_to_sparse_dict(pb, ("",), torch.device("cpu"))
    pred = pm(dd)
    training.masked_l1_loss(pred, dd["y"], dd["graph_mask"]).backward()
    assert np.abs(pred.detach().numpy() - np.asarray(jpred)).max() < 1e-4
    params = dict(pm.named_parameters())
    noisy = bn_fed_biases(pm)
    checked = 0
    for path, g in nnx.to_flat_state(jg):
        name, transpose = _port_name(path)
        if name not in params or name in noisy:
            continue
        g = np.asarray(g.get_value())
        got = params[name].grad.numpy()
        assert maxrel(got, g.T if transpose else g) < 2e-4, name
        checked += 1
    assert checked == len(params) - len(noisy & set(params))


@pytest.mark.parametrize("num_layer,hiddim", [(2, 16), (3, 64)])
def test_ngat_predictions_match_jax(rng, num_layer, hiddim):
    """``SpModel("NGAT")`` in eval mode, called on the port's batches and
    through ``SpPredictor``, against the JAX ``SpPredictor``
    (``build_plans=False``: the unfused path), with seeded non-identity
    BatchNorm statistics.  Tolerance 1e-4 abs on predictions of order 1:
    f32 on both sides, sums in another order through the layers."""
    jx_graphs = jx_synthetic_zinc("val", n_graphs=20)
    jm, keys = _jax_model(num_layer, hiddim)
    randomize_bn(jm, rng)
    jm.eval()
    ref = JxSpPredictor(jm, partial(JxKhopSampler, hop=3), keys,
                        batch_size=8, build_plans=False)(jx_graphs)

    pm = _port_model(jm, num_layer, hiddim)
    pm.eval()
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], keys)
    graphs = synthetic_zinc("val", n_graphs=20)
    with torch.no_grad():
        outs = []
        for b in SpDataloader([pre(g) for g in graphs], 8, keys):
            dd = batch_to_sparse_dict(b, ("",), torch.device("cpu"))
            outs.append(pm(dd)[dd["graph_mask"]].numpy())
    assert np.abs(np.concatenate(outs) - ref).max() < 1e-4
    predictor = SpPredictor(pm, partial(KhopSampler, hop=3), keys,
                            batch_size=8, device="cpu")
    out = predictor(graphs)
    assert out.shape == ref.shape == (20, 1)
    assert np.abs(ref).max() > 0.1          # the check is not vacuous
    assert np.abs(out - ref).max() < 1e-4


def test_ngat_training_trajectory_matches_jax():
    """NGAT-SS, 2 layers x 32, 16 graphs in shuffled batches of 8, ten
    AdamW steps at lr 1e-3 through the port's ``make_sparse_steps`` and
    the JAX package's (its unfused path), from the same weights.

    Per-step losses: 1e-5 relative (f32, sums in another order).  Final
    parameters and BatchNorm statistics: 1e-5 abs + 1e-5 relative, except
    the biases of :func:`bn_fed_biases`, whose gradient is 0 in exact
    arithmetic, so AdamW turns its rounding into steps of up to about lr
    each, and the running means they shift: those are held to 1.25 *
    lr a step on each side (the bound of |m_hat| / sqrt(v_hat) for
    t <= 10 with optax's betas), as the NGNN trajectory test does."""
    L, H, G, BS, STEPS, LR = 2, 32, 16, 8, 10, 1e-3
    jm, keys = _jax_model(L, H)
    start = jax_params(jm)
    jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    # workers=1: the JAX loader collates batches 2.. on a thread pool
    # that grows shared shape buckets as it goes
    # (pygho_tpu/hodata/loader.py:104-125), so its padding would depend
    # on thread timing; the port's loader collates in order
    jdl = JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
        "train", n_graphs=G)], BS, keys, shuffle=True, drop_last=True,
        seed=3, device_put=False, prefetch=0, workers=1)
    jstep, _ = jx_training.make_sparse_steps()
    jopt = jx_training.make_optimizer(jm, LR)
    jm.train()

    pm = _port_model(jm, L, H)
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
        jl.append(float(jstep(jm, jopt, jb)))
        pl.append(float(pstep(pm, popt, pb)))
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-5 * np.abs(jl)), (pl, jl)

    noisy = bn_fed_biases(pm)
    assert noisy
    params = dict(pm.named_parameters())
    targets = dict(params)
    targets.update(pm.named_buffers())
    adam_bound = 2 * STEPS * 1.25 * LR
    checked = set()
    for path, ref in jax_params(jm).items():
        name, transpose = _port_name(path)
        got = targets[name].detach().numpy()
        ref = ref.T if transpose else ref
        if name in params:
            assert not np.array_equal(got, start[path].T if transpose
                                      else start[path]), f"{name} is stuck"
        if name in noisy:
            assert np.abs(got - ref).max() <= adam_bound, name
        else:
            assert np.allclose(got, ref, rtol=1e-5, atol=1e-5), name
        checked.add(name)
    assert checked == set(targets)


@pytest.mark.parametrize("what", ["aggr", "mode", "edge values", "conv"])
def test_ngat_refusals(what):
    """What is not ported raises ``NotImplementedError``: another
    aggregation, another mode and an adjacency without edge values; a
    conv that is not in the table raises ``ValueError``, as in the JAX
    package, and the message lists the table, every sparse conv."""
    if what == "aggr":
        with pytest.raises(NotImplementedError, match="aggr"):
            pt_conv.NGATConv(8, 8, "mean", "SS", MLP1, **GEN)
        with pytest.raises(NotImplementedError, match="aggr"):
            make_sp_model("NGAT", num_layer=1, hiddim=8, aggr="max",
                          device="cpu")
    elif what == "mode":
        with pytest.raises(NotImplementedError, match="mode"):
            pt_conv.NGATConv(8, 8, "sum", "DD", MLP1, **GEN)
    elif what == "edge values":
        conv = pt_conv.NGATConv(8, 8, "sum", "SS", MLP1, **GEN)
        A = SparseTensor(torch.zeros(2, 3, dtype=torch.long), None, 3,
                         (4, 4))
        X = SparseTensor(torch.zeros(2, 5, dtype=torch.long),
                         torch.zeros(5, 8), 5, (4, 4))
        with pytest.raises(NotImplementedError, match="edge values"):
            conv(A, X, {})
    else:
        with pytest.raises(ValueError,
                           match=r"\['DSSGNN', 'GNNAK', 'I2GNN', 'NGAT', "
                                 r"'NGNN', 'PPGN', 'SSWL', 'SUN'\]"):
            make_sp_model("GIN", device="cpu")
