"""The training slice of the port against the JAX package, on the CPU: K1's
gradients through ``SpspmmSum`` (whose backward runs the dX and dA roles'
plain versions here, on the same host orders the card's kernels read),
the backward orders built by the loader, the shuffled loader, the
schedule, the loss, AdamW, and a short NGNN-SS training trajectory with
the JAX weights carried across.

Every input comes from a numpy seed; each test states its tolerance."""

import copy
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from pygho_tpu.backend.sptensor import SparseTensor as JxSparseTensor
from pygho_tpu.backend.spspmm import spspmm as jx_spspmm
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.kernels.fused_spspmm import build_spspmm_plans, fused_spspmm
from pygho_tpu.kernels.strip_spspmm import (autotune_strip_geoms,
                                            build_spspmm_strip_plans,
                                            fused_spspmm_strip)
from pygho_tpu.models import make_sp_model as jx_make_sp_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.backend.spspmm import spspmm
from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.hodata.loader import add_rowptr, backward_orders
from pygho_tpu_torch.honn.utils import MLP
from pygho_tpu_torch.kernels import spspmm_sum
from pygho_tpu_torch.kernels.spspmm_sum import SpspmmSum
from pygho_tpu_torch.models import make_sp_model
from pygho_tpu_torch.models import training
from pygho_tpu_torch.weights import load_jax_params

REPO = Path(__file__).resolve().parent.parent
KEY = "X___X___1___A___0"
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
# K1 and its gradients against JAX: the same f32 products of values of
# order 1, summed in another order; a dA row sums tens of products
GRAD_TOL = 1e-4


def _batch(n_graphs, hop=3):
    pre = JxSppretransform(partial(JxKhopSampler, hop=hop), [""], [KEY])
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=n_graphs)]
    return jx_collate_sparse(datas, [KEY], [""], n_graphs)


def _uvw(rng, batch, D):
    """Operands with zero padded rows, as in the model, and a cotangent."""
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    U = rng.normal(size=(nt, D)).astype(np.float32)
    V = rng.normal(size=(ne, D)).astype(np.float32)
    U[int(batch["num_tuples"]):] = 0
    V[int(batch["num_edges"]):] = 0
    W = rng.normal(size=(nt, D)).astype(np.float32)
    return U, V, W


def _port_vjp(batch, U, V, W):
    """The port's spspmm forward and its gradients for cotangent W."""
    b = copy.deepcopy(batch)
    add_rowptr(b, [KEY], backward=True)
    n_pad = b["x"].shape[0]
    Ut = torch.from_numpy(U).requires_grad_()
    Vt = torch.from_numpy(V).requires_grad_()
    X = SparseTensor(torch.from_numpy(b["tupleid"]).long(), Ut,
                     int(b["num_tuples"]), (n_pad, n_pad))
    A = SparseTensor(torch.from_numpy(b["edge_index"]).long(), Vt,
                     int(b["num_edges"]), (n_pad, n_pad))
    t = {k: torch.from_numpy(b[f"{KEY}___{k}"]) for k in
         ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da", "rowptr_da")}
    out = spspmm(X, 1, A, 0, "sum", acd=t["acd"], rowptr=t["rowptr"],
                 tarX=X, bwd=(t["acd_dx"], t["rowptr_dx"], t["acd_da"],
                              t["rowptr_da"])).values
    (out * torch.from_numpy(W)).sum().backward()
    return out.detach().numpy(), Ut.grad.numpy(), Vt.grad.numpy()


def _assert_close(port, ref):
    for p, r in zip(port, ref):
        assert p.shape == r.shape
        assert np.abs(p - r).max() < GRAD_TOL


@pytest.mark.parametrize("D", [128, 16, 5])
def test_spspmm_grads_match_jax_xla(rng, D):
    batch = _batch(8)
    U, V, W = _uvw(rng, batch, D)
    n_pad = batch["x"].shape[0]

    def f(u, v):
        X = JxSparseTensor(jnp.asarray(batch["tupleid"]), u,
                           jnp.asarray(batch["num_tuples"]), (n_pad, n_pad))
        A = JxSparseTensor(jnp.asarray(batch["edge_index"]), v,
                           jnp.asarray(batch["num_edges"]), (n_pad, n_pad))
        return jx_spspmm(X, 1, A, 0, "sum",
                         acd=jnp.asarray(batch[f"{KEY}___acd"]),
                         tarX=X).values

    out, vjp = jax.vjp(f, jnp.asarray(U), jnp.asarray(V))
    dU, dV = vjp(jnp.asarray(W))
    port = _port_vjp(batch, U, V, W)
    _assert_close(port, [np.asarray(out), np.asarray(dU), np.asarray(dV)])
    assert np.abs(np.asarray(dV)).max() > 1    # not vacuous
    # padded rows get no gradient
    assert np.all(port[1][int(batch["num_tuples"]):] == 0)
    assert np.all(port[2][int(batch["num_edges"]):] == 0)


def test_spspmm_grads_match_tpu_strip_kernel(rng):
    """D = 128 on a 4-graph batch against the TPU kernel's VJP
    (``fused_spspmm_strip`` in interpret mode), on plans built the way the
    JAX loader builds them."""
    batch = _batch(4)
    acd = batch[f"{KEY}___acd"]
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    geoms = autotune_strip_geoms(acd, nt, ne, nt, D=128, probe=False)
    plans = build_spspmm_strip_plans(acd, nt, ne, nt, geoms)
    U, V, W = _uvw(rng, batch, 128)
    out, vjp = jax.vjp(
        lambda u, v: fused_spspmm_strip(u, v, *plans, True)[:nt],
        jnp.asarray(U), jnp.asarray(V))
    dU, dV = vjp(jnp.asarray(W))
    _assert_close(_port_vjp(batch, U, V, W),
                  [np.asarray(out), np.asarray(dU), np.asarray(dV)])


def test_spspmm_matches_k2_fused_spspmm(rng):
    """K2: the v1 chunk-plan kernel (``fused_spspmm`` in interpret mode,
    plans from ``build_spspmm_plans``) computes the same contraction; the
    port's forward and both gradients are held against it, D = 128 on a
    4-graph batch."""
    batch = _batch(4)
    acd = batch[f"{KEY}___acd"]
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    plans = build_spspmm_plans(acd, nt, ne, nt)
    U, V, W = _uvw(rng, batch, 128)
    out, vjp = jax.vjp(lambda u, v: fused_spspmm(u, v, *plans, True)[:nt],
                       jnp.asarray(U), jnp.asarray(V))
    dU, dV = vjp(jnp.asarray(W))
    _assert_close(_port_vjp(batch, U, V, W),
                  [np.asarray(out), np.asarray(dU), np.asarray(dV)])


def test_backward_orders_from_the_loader():
    """Each backward role's triples are the forward's real triples, each
    once, permuted into (c, a, d) and (d, c, a), sorted by their output
    row, stably (the forward's order kept within a row), in range, with
    a row pointer that covers them."""
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in synthetic_zinc("val", n_graphs=12)]
    batch = next(iter(SpDataloader(datas, 12, [KEY], backward=True)))
    acd = batch[f"{KEY}___acd"].astype(np.int64)
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    k = acd.shape[1]
    assert k > 100
    pos = {tuple(t): i for i, t in enumerate(acd.T)}
    assert len(pos) == k                        # forward triples unique
    for role, perm, rows in (("dx", (1, 0, 2), nt), ("da", (2, 1, 0), ne)):
        tuv = batch[f"{KEY}___acd_{role}"]
        rowptr = batch[f"{KEY}___rowptr_{role}"]
        assert tuv.dtype == np.int32 and rowptr.dtype == np.int32
        assert tuv.shape == (3, k) and rowptr.shape == (rows + 1,)
        t = tuv[0].astype(np.int64)
        assert np.all(np.diff(t) >= 0) and t.min() >= 0 and t.max() < rows
        assert rowptr[0] == 0 and rowptr[-1] == k
        assert np.array_equal(np.diff(rowptr),
                              np.bincount(t, minlength=rows))
        # back to (a, c, d): the forward's triples, each exactly once
        inv = np.argsort(perm)
        src = np.array([pos[tuple(x)] for x in tuv[inv].T.astype(np.int64)])
        assert np.array_equal(np.sort(src), np.arange(k))
        # stable: within one output row, forward order
        same = t[1:] == t[:-1]
        assert np.all(src[1:][same] > src[:-1][same])
        v_rows = ne if role == "dx" else nt
        assert tuv[1:].min() >= 0 and tuv[1].max() < nt \
            and tuv[2].max() < v_rows
    # without the flag, serving's batches carry no backward orders
    plain = next(iter(SpDataloader(datas, 12, [KEY])))
    assert f"{KEY}___acd_dx" not in plain and f"{KEY}___acd_da" not in plain


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffled_loader_matches_jax(seed):
    """Two epochs of ``SpDataloader(shuffle=True, drop_last=True,
    seed=s)``: the same graphs in the same batches as the JAX loader."""
    n, bs = 22, 5
    jpre = JxSppretransform(partial(JxKhopSampler, hop=2), [""], [KEY])
    # workers=1: the JAX loader collates batches 2.. on a thread pool
    # that grows shared shape buckets as it goes
    # (pygho_tpu/hodata/loader.py:104-125), so its padding would depend
    # on thread timing; the port's loader collates in order
    jdl = JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
        "train", n_graphs=n)], bs, [KEY], shuffle=True, drop_last=True,
        seed=seed, device_put=False, prefetch=0, workers=1)
    pre = Sppretransform(partial(KhopSampler, hop=2), [""], [KEY])
    pdl = SpDataloader([pre(g) for g in synthetic_zinc("train",
                                                        n_graphs=n)],
                       bs, [KEY], shuffle=True, drop_last=True, seed=seed)
    assert len(pdl) == len(jdl) == n // bs
    epochs = []
    for _ in range(2):
        jb, pb = list(jdl), list(pdl)
        assert len(jb) == len(pb) == n // bs
        for j, p in zip(jb, pb):
            for name in ("y", "x", "graph_mask", "tupleid", "edge_index"):
                assert np.array_equal(np.asarray(j[name]), p[name]), name
        epochs.append(np.concatenate([p["y"] for p in pb]))
    assert not np.array_equal(epochs[0], epochs[1])   # reshuffled
    # drop_last=False keeps the last partial batch, padded
    tail = SpDataloader(pdl.dataset, bs, [KEY])
    assert len(tail) == len(list(tail)) == -(-n // bs)


@pytest.mark.parametrize("T_mult", [1, 2])
def test_cosine_warm_restarts_matches_jax(T_mult):
    """Per step over five cycles, K and K2 > 0.  Tolerance 1e-6 of the
    base rate: the JAX schedule is evaluated in f32."""
    kw = dict(base_lr=1e-3, T0=3, steps_per_epoch=7, eta_min=1e-5, K=0.5,
              K2=0.1, T_mult=T_mult)
    ref = jx_training.cosine_warm_restarts(**kw)
    port = training.cosine_warm_restarts(**kw)
    steps = np.arange(0, 7 * 3 * (1 + T_mult + T_mult ** 2) + 5)
    got = np.array([port(int(s)) for s in steps])
    want = np.array([float(ref(jnp.asarray(s))) for s in steps])
    assert np.abs(got - want).max() < 1e-6 * kw["base_lr"]
    assert got.max() > 0.9e-3 and got.min() < 0.1e-3   # restarts happen
    with pytest.raises(ValueError):
        training.cosine_warm_restarts(1e-3, 3, 7, T_mult=1.5)


def test_masked_l1_loss_matches_jax(rng):
    pred = rng.normal(size=(9, 2)).astype(np.float32)
    y = rng.normal(size=(9, 2)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 0, 1], bool)
    ref = float(jx_training.masked_l1_loss(jnp.asarray(pred),
                                           jnp.asarray(y),
                                           jnp.asarray(mask)))
    got = float(training.masked_l1_loss(torch.from_numpy(pred),
                                        torch.from_numpy(y),
                                        torch.from_numpy(mask)))
    assert abs(got - ref) < 1e-6
    empty = training.masked_l1_loss(torch.from_numpy(pred),
                                    torch.from_numpy(y),
                                    torch.zeros(9, dtype=torch.bool))
    assert float(empty) == 0.0


def test_adamw_updates_match_optax(rng):
    """Three AdamW updates with weight decay and a schedule, against
    ``optax.adamw``.  Tolerance 1e-6 abs on parameters of order 1
    (updates of order 1e-3, f32)."""
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10 ** -e
              for s in shapes] for e in (0, 2, 4)]
    sched = training.cosine_warm_restarts(1e-2, 1, 2, K=0.3)
    jsched = jx_training.cosine_warm_restarts(1e-2, 1, 2, K=0.3)
    tx = optax.adamw(jsched, weight_decay=0.05)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = training.AdamW(tp, sched, weight_decay=0.05)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p, r, p0 in zip(tp, jp, params):
        assert np.abs(p.detach().numpy() - np.asarray(r)).max() < 1e-6
        assert np.abs(p.detach().numpy() - p0).max() > 1e-3  # it moved
    # make_optimizer: parameters only, optax's defaults, JAX's decay 0
    m = make_sp_model("NGNN", num_layer=1, hiddim=8, device="cpu")
    opt = training.make_optimizer(m, 1e-3)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) \
        == ((0.9, 0.999), 1e-8, 0.0)
    assert len(group["params"]) == len(list(m.parameters()))
    assert not {id(b) for b in m.buffers()} & {id(p) for p in
                                               group["params"]}


def _bn_fed_biases(model):
    """Names of the Linear biases that feed a BatchNorm, and of the
    running means of those norms."""
    names = set()
    for prefix, mod in model.named_modules():
        if not isinstance(mod, MLP):
            continue
        for i in range(len(mod.hid_lins)):
            names |= {f"{prefix}.hid_lins.{i}.bias",
                      f"{prefix}.hid_norms.{i}.mean"}
        if mod.tail_lin is not None and mod.tailact:
            names |= {f"{prefix}.tail_lin.bias", f"{prefix}.tail_norm.mean"}
    return names


def _flat(jm):
    return {path: np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(jm))}


def _port_name(path):
    dotted = ".".join(str(p) for p in path)
    prefix, _, leaf = dotted.rpartition(".")
    if leaf in ("kernel", "embedding"):
        return f"{prefix}.weight", leaf == "kernel"
    return dotted, False


def test_training_trajectory_matches_jax():
    """NGNN-SS, 2 layers x 32, 16 graphs in shuffled batches of 8, ten
    AdamW steps at lr 1e-3 through the port's ``make_sparse_steps`` and
    the JAX package's, from the same weights (parity bar 3's ten steps).

    Per-step losses: 1e-5 relative (f32, sums in another order).  Final
    parameters and BatchNorm statistics: 1e-5 abs + 1e-5 relative, except
    the Linear biases that feed a BatchNorm and the running means of those
    norms.  Such a bias has a zero gradient in exact arithmetic (the norm
    subtracts the batch mean), so AdamW turns its rounding-level gradient
    into steps of up to about lr each, with signs that differ between two
    correct implementations.  Those are held to what AdamW allows in ten
    steps: 1.05 * lr a step on each side.  That is the bound of |m_hat| /
    sqrt(v_hat) for t <= 10 with optax's betas (0.9, 0.999): by
    Cauchy-Schwarz over the bias-corrected weights of the gradients it is
    at most sqrt(sum_i w_i^2 / u_i), which grows with t and is 1.0431 at
    t = 10."""
    L, H, G, BS, STEPS, LR = 2, 32, 16, 8, 10, 1e-3
    jm = jx_make_sp_model("NGNN", num_layer=L, hiddim=H, mlp=dict(MLPD))
    keys = jx_keys(jm)
    start = _flat(jm)
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
        jl.append(float(jstep(jm, jopt, jb)))
        pl.append(float(pstep(pm, popt, pb)))
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-5 * np.abs(jl)), (pl, jl)

    noisy = _bn_fed_biases(pm)
    assert noisy
    params = dict(pm.named_parameters())
    targets = dict(params)
    targets.update(pm.named_buffers())
    adam_bound = 2 * STEPS * 1.05 * LR
    checked = set()
    for path, ref in _flat(jm).items():
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


def test_raw_wrapper_refuses_a_tensor_that_requires_grad(rng):
    """Outside the Function, a raw K1 wrapper builds no graph, so it
    refuses an input that requires grad while grad mode is on; under
    ``no_grad`` it runs, and ``SpspmmSum`` differentiates the same roles."""
    U = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    acd = torch.tensor([[0, 0, 2], [1, 3, 3], [0, 2, 1]], dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32)
    for fn in (partial(spspmm_sum.contract, role)
               for role in spspmm_sum.ROLES):
        with pytest.raises(RuntimeError, match="SpspmmSum"):
            fn(U.clone().requires_grad_(), V, acd, rowptr)
        with pytest.raises(RuntimeError, match="SpspmmSum"):
            fn(U, V.clone().requires_grad_(), acd, rowptr)
        with torch.no_grad():
            fn(U.clone().requires_grad_(), V, acd, rowptr)
    orders = backward_orders(acd.numpy(), 4, 3)
    bwd = tuple(torch.from_numpy(x) for role in ("dx", "da")
                for x in orders[role])
    Ug, Vg = U.clone().requires_grad_(), V.clone().requires_grad_()
    out = SpspmmSum.apply(Ug, Vg, acd, rowptr, bwd)
    out.sum().backward()
    ref_U, ref_V = U.clone().requires_grad_(), V.clone().requires_grad_()
    spspmm_sum.contract_plain(ref_U, ref_V, acd, 4).sum().backward()
    assert torch.allclose(Ug.grad, ref_U.grad, atol=1e-6)
    assert torch.allclose(Vg.grad, ref_V.grad, atol=1e-6)


def test_function_runs_only_the_roles_it_needs(rng, monkeypatch):
    """``needs_input_grad`` skips a role; a backward with no backward
    orders raises instead of dropping the gradient."""
    U = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    acd = torch.tensor([[0, 0, 2], [1, 3, 3], [0, 2, 1]], dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32)
    orders = backward_orders(acd.numpy(), 4, 3)
    bwd = tuple(torch.from_numpy(x) for role in ("dx", "da")
                for x in orders[role])
    calls = []
    real = spspmm_sum.contract

    def spy(role, *args):
        calls.append(role.NAME)
        return real(role, *args)

    monkeypatch.setattr(spspmm_sum, "contract", spy)
    Ug = U.clone().requires_grad_()
    SpspmmSum.apply(Ug, V, acd, rowptr, bwd).sum().backward()
    assert calls == [spspmm_sum.FWD.NAME, spspmm_sum.DX.NAME]
    calls.clear()
    Vg = V.clone().requires_grad_()
    SpspmmSum.apply(U, Vg, acd, rowptr, bwd).sum().backward()
    assert calls == [spspmm_sum.FWD.NAME, spspmm_sum.DA.NAME]
    assert Ug.grad is not None and Vg.grad is not None
    out = SpspmmSum.apply(U.clone().requires_grad_(), V, acd, rowptr, None)
    with pytest.raises(RuntimeError, match="backward=True"):
        out.sum().backward()
    with pytest.raises(ValueError, match="backward row pointers"):
        SpspmmSum.apply(U, V, acd, rowptr, bwd[::-1])


def _run_example(*flags):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "example/minimal_gpu.py", *flags],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_minimal_gpu_example_trains_on_the_cpu():
    """``example/minimal_gpu.py --cpu`` trains an epoch (narrow, to stay
    quick) and prints one JSON line with ``log_epoch``'s fields."""
    r = _run_example("--cpu", "--epochs", "1", "--hiddim", "16",
                     "--num_layer", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.splitlines()[0])
    assert set(rec) == {"type", "epoch", "trn_time", "val_time", "mem_gb",
                        "trn_loss", "val_mae", "tst_mae", "lr"}
    assert rec["epoch"] == 1 and np.isfinite(rec["trn_loss"])
    assert np.isfinite(rec["val_mae"]) and np.isfinite(rec["tst_mae"])


def test_minimal_gpu_example_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_example("--epochs", "1", "--hiddim", "8", "--num_layer", "1")
    assert r.returncode != 0 and "device='cpu'" in r.stderr
    assert not r.stdout.strip()
