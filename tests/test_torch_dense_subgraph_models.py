"""The subgraph convs' dense models against the JAX package, on the CPU:
``make_ma_model(conv, mode="DD"|"SD", device="cpu")`` for SSWL, DSSGNN,
GNNAK and SUN with the JAX weights carried across by
``weights.load_jax_params``: predictions in DD, in SD on the densify route
and, for SSWL, on the fused route (K1 on the loader's ``(1, 2)`` and
``(1, 1)`` triples); ``MaModel(remat=True)`` against ``remat=False``;
``MaPredictor`` in both adjacency modes.  The operators under them:
``tests/test_torch_dense_subgraph_ops.py``; their training against JAX's:
``tests/test_torch_dense_subgraph_training.py``.

Models of 2 layers x 16 on eight ``synthetic_zinc`` graphs (n padded to
32), with the settings of the convs' dense rows in
``scripts/converged_matrix.sh`` (hop-4 ``spdsampler``, mlplayer 2,
outlayer 4, npool sum, lpool sum, cpool mean); norm statistics from numpy
seeds.  Each test states its tolerance.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import MaDataloader as JxMaDataloader
from pygho_tpu.hodata.loader import Mapretransform as JxMapretransform
from pygho_tpu.hodata.ma_data import batch_to_dense_dict as jx_to_dict
from pygho_tpu.hodata.ma_sampler import spdsampler as jx_spdsampler
from pygho_tpu.honn.ma_operator import parse_spmamm_dims as jx_spmamm_dims
from pygho_tpu.models import MaPredictor as JxMaPredictor
from pygho_tpu.models import make_ma_model as jx_make_ma_model

from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                    batch_to_dense_dict, spdsampler,
                                    synthetic_zinc)
from pygho_tpu_torch.honn import parse_spmamm_dims
from pygho_tpu_torch.kernels import channelwise_bmm as k5
from pygho_tpu_torch.kernels import spspmm_sum as k1
from pygho_tpu_torch.models import (MaPredictor, make_dense_steps,
                                    make_ma_model, make_optimizer,
                                    masked_l1_loss)
from pygho_tpu_torch.weights import load_jax_params
from test_torch_subgraph_convs import CPU, jax_params, maxrel, randomize_bn

CONVS = ["SSWL", "DSSGNN", "GNNAK", "SUN"]
MLPD = {"dp": 0.0, "norm": "bn", "act": "silu", "normparam": 0.31,
        "numlayer": 2, "tailact": True}
KW = dict(num_layer=2, hiddim=16, npool="sum", lpool="sum", cpool="mean",
          outlayer=4)
# K5 (or K1) launches a forward: SSWL's within and cross products a
# layer, one product a layer for the others
PRODUCTS = {"SSWL": 2, "DSSGNN": 1, "GNNAK": 1, "SUN": 1}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test computes on one PyTorch thread, the setting restored
    after it: under xdist several workers share the host's cores, and
    PyTorch's intra-op threads, one a core in every worker, then slow
    each other down many times over (these files: 424 s on four workers
    with the default threads, 68 s with one)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _models(conv, mode, rng=None, **kw):
    """The JAX ``MaModel`` (seeded non-identity BatchNorm statistics where
    ``rng`` is given) and the port's with its weights."""
    jm = jx_make_ma_model(conv, mode=mode, mlp=dict(MLPD), **KW)
    if rng is not None:
        randomize_bn(jm, rng)
    pm = make_ma_model(conv, mode=mode, mlp=dict(MLPD), device="cpu", **KW,
                       **kw)
    load_jax_params(pm, jax_params(jm))
    assert parse_spmamm_dims(pm) == jx_spmamm_dims(jm)
    return jm, pm


def _datas(port, split="val", n_graphs=8):
    if port:
        pre = Mapretransform(partial(spdsampler, hop=4))
        return [pre(g) for g in synthetic_zinc(split, n_graphs=n_graphs)]
    pre = JxMapretransform(partial(jx_spdsampler, hop=4))
    return [pre(g) for g in jx_synthetic_zinc(split, n_graphs=n_graphs)]


def _loaders(mode, plans, dims, split="val", n_graphs=8, **kw):
    """The JAX loader (``workers=1``, its plans on the fused route) and
    the port's over the same graphs."""
    dense = mode == "DD"
    jdl = JxMaDataloader(_datas(False, split, n_graphs), 8, denseadj=dense,
                         build_plans=plans, plan_dims=dims or ((1, 2),),
                         plan_geometry="auto", device_put=False, prefetch=0,
                         workers=1, **kw)
    pdl = MaDataloader(_datas(True, split, n_graphs), 8, denseadj=dense,
                       build_plans=plans, plan_dims=dims or ((1, 2),), **kw)
    return jdl, pdl


def _count_kernels(monkeypatch):
    """Record every call of K5's and K1's plain versions."""
    calls = []
    for mod, name in ((k5, "cw_bmm_plain"), (k1, "contract_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, partial(
            lambda fn, name, *a, **k: calls.append(name) or fn(*a, **k),
            fn, name))
    return calls


@pytest.mark.parametrize("conv,mode,route", [
    *[(conv, "DD", None) for conv in CONVS],
    *[(conv, "SD", "densify") for conv in CONVS],
    ("SSWL", "SD", "fused")])
def test_ma_model_predictions_match_jax(rng, monkeypatch, conv, mode,
                                        route):
    """``make_ma_model(conv, mode=...)`` in eval mode, with the JAX
    weights and seeded BatchNorm statistics, on one batch of eight
    ``synthetic_zinc("val")`` graphs: DD, SD on the densify route (neither
    loader builds plans) and SSWL-SD on the fused route (both loaders
    build the plans of ``parse_spmamm_dims``: ``(1, 1)`` and ``(1, 2)``;
    the JAX model runs K2 in interpret mode).  Within 1e-5 of
    max(|prediction|, 1): ``test_torch_dense_ngnn.py``'s 1e-5 abs on
    predictions of order 1, and f32 rounding's relative share where the
    sum pools over (n, n) tuples and the seeded norms make them larger
    (up to about 70 here; sums in other orders through two layers).
    The kernel each path takes is counted through the plain versions: K5
    once a product and layer (SSWL's cross product at ``(1, 1)`` too), or
    K1 on the fused route."""
    plans = route == "fused"
    jm, pm = _models(conv, mode, rng)
    dims = parse_spmamm_dims(pm)
    assert dims == ([] if mode == "DD" else
                    [(1, 1), (1, 2)] if conv == "SSWL" else [(1, 2)])
    jdl, pdl = _loaders(mode, plans, dims)
    jb, pb = next(iter(jdl)), next(iter(pdl))
    if plans:
        assert {f"spmamm___{a}___{b}___plan" for a, b in dims} <= set(jb)
        assert {f"spmamm___{a}___{b}___acd" for a, b in dims} <= set(pb)
    calls = _count_kernels(monkeypatch)
    jm.eval()
    pm.eval()
    ref = np.asarray(jm(jx_to_dict(jb)))
    with torch.no_grad():
        out = pm(batch_to_dense_dict(pb, ("",), CPU)).numpy()
    want = "contract_plain" if plans else "cw_bmm_plain"
    assert calls == [want] * (PRODUCTS[conv] * KW["num_layer"])
    assert out.shape == ref.shape == (8, 1)
    assert np.isfinite(out).all() and np.abs(ref).max() > 0.1
    assert np.all(np.abs(out - ref) <= 1e-5 * np.maximum(np.abs(ref), 1))


def test_sswl_sd_fused_route_matches_densify():
    """``MaDataloader(plan_dims=parse_spmamm_dims(model))`` on SSWL-SD
    gives each batch the ``(1, 1)`` pair's triples, row pointer and both
    backward orders beside the ``(1, 2)`` pair's (the same triples: they
    depend on the contracted adjacency dim alone), and a training step on
    the fused route (K1 on both) matches one on the densify route (K5)
    from the same weights: the loss within 1e-6 relative and every
    gradient within 1e-5 of its largest entry (f32 sums in other
    orders)."""
    models = [make_ma_model("SSWL", mode="SD", mlp=dict(MLPD), device="cpu",
                            **KW) for _ in range(2)]
    dims = parse_spmamm_dims(models[0])
    assert dims == [(1, 1), (1, 2)]
    batches = [next(iter(MaDataloader(_datas(True, "train", 8), 8,
                                      denseadj=False, build_plans=plans,
                                      plan_dims=dims)))
               for plans in (True, False)]
    fused = batches[0]
    for what in ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da",
                 "rowptr_da"):
        a, b = (fused[f"spmamm___{d1}___{d2}___{what}"] for d1, d2 in dims)
        assert a.dtype == np.int32 and np.array_equal(a, b), what
    assert not any(k.startswith("spmamm") for k in batches[1])
    losses, grads = [], []
    for m, b in zip(models, batches):
        m.train()
        dd = batch_to_dense_dict(b, ("",), CPU)
        loss = masked_l1_loss(m(dd), dd["y"], dd["graph_mask"])
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[1])
    for k, g in grads[1].items():
        assert maxrel(grads[0][k].numpy(), g.numpy()) < 1e-5, k


@pytest.mark.parametrize("conv,mode", [*[(conv, "DD") for conv in CONVS],
                                       ("SSWL", "SD"), ("SUN", "SD")])
def test_remat_matches_no_remat(conv, mode):
    """``MaModel(remat=True)`` (each layer under non-reentrant
    ``torch.utils.checkpoint``, recomputed in the backward pass) against
    ``remat=False`` from the same seed, two training steps on the same
    batches (SD on the fused route): the same losses, gradients,
    parameters and BatchNorm running statistics, bit for bit (the same
    operations in the same order; the recompute leaves the running
    statistics alone).  Under ``no_grad`` it checkpoints nothing."""
    plans = mode == "SD"
    models = [make_ma_model(conv, mode=mode, mlp=dict(MLPD), device="cpu",
                            remat=remat, **KW) for remat in (False, True)]
    dims = parse_spmamm_dims(models[0])
    pdl = MaDataloader(_datas(True, "train", 16), 8, denseadj=mode == "DD",
                       build_plans=plans, plan_dims=dims or ((1, 2),))
    step, _ = make_dense_steps()
    runs = []
    for m in models:
        opt = make_optimizer(m, 1e-3)
        m.train()
        losses, grads = [], []
        for b in pdl:
            losses.append(float(step(m, opt, b)))
            grads.append({k: p.grad.clone()
                          for k, p in m.named_parameters()})
        runs.append((losses, grads, m.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1 and len(set(l0)) == 2
    for a, b in zip(g0, g1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert s0.keys() == s1.keys()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    for m in models:
        m.eval()
    with torch.no_grad():
        dd = batch_to_dense_dict(next(iter(pdl)), ("",), CPU)
        assert torch.equal(models[0](dd), models[1](dd))


@pytest.mark.parametrize("mode", ["DD", "SD"])
def test_ma_predictor_matches_jax(rng, mode):
    """``MaPredictor`` serving SUN (its seven branches and
    ``HeteroLinear`` on the (b, n, n) diagonal mask) against the JAX one
    on 13 raw graphs in batches of 8, on the dense adjacency and on the
    sparse one (``denseadj=False``: the densify route, neither builds
    plans): the same predictions in input order, within 1e-5 of
    max(|prediction|, 1), as the model test holds them."""
    jm, pm = _models("SUN", mode, rng)
    dense = mode == "DD"
    graphs = jx_synthetic_zinc("val", n_graphs=13)
    ref = JxMaPredictor(jm, partial(jx_spdsampler, hop=4), batch_size=8,
                        denseadj=dense)(graphs)
    pred = MaPredictor(pm, partial(spdsampler, hop=4), batch_size=8,
                       denseadj=dense, device="cpu")
    out = pred(synthetic_zinc("val", n_graphs=13))
    assert out.shape == (13, 1) and np.abs(ref).max() > 0.1
    assert np.all(np.abs(out - ref) <= 1e-5 * np.maximum(np.abs(ref), 1))
    assert jnp.isfinite(jnp.asarray(ref)).all()
