"""I2GNN in sparse mode as a model against the JAX package, on the CPU:
``make_sp_model("I2GNN", device="cpu")`` with the JAX weights carried
across by ``weights.load_jax_params`` (the 3-tuple encoders and the third
tuple-init layer among them): predictions on ZINC-like and subgraph-count
batches, the gradient of every parameter and a four-step AdamW trajectory,
``recalibrate_batchnorm``, and serving through ``SpPredictor`` with
``I2Sampler``.  The operators and the layer:
``tests/test_torch_i2gnn.py``; the entry points:
``tests/test_torch_i2gnn_apps.py``.

Models of 2 layers x 32 on a few graphs; inputs and norm statistics come
from numpy seeds.  Each test states its tolerance.
"""

from functools import partial

import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.hodata import datasets as jx_datasets
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_sampler import I2Sampler as JxI2Sampler
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.honn.utils import recalibrate_batchnorm as jx_recalibrate
from pygho_tpu.models import make_sp_model as jx_make_sp_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.hodata import (I2Sampler, SpDataloader,
                                    Sppretransform, synthetic_subgraphcount,
                                    synthetic_zinc)
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import parse_precomputekey, recalibrate_batchnorm
from pygho_tpu_torch.models import SpPredictor, make_sp_model, training
from pygho_tpu_torch.weights import load_jax_params
from test_torch_subgraph_convs import (CPU, MLPD, _port_name, bn_fed_biases,
                                       jax_params, maxrel, randomize_bn)

KEY3 = "X___X___2___A___0"


def _graphs(source, n_graphs, split="train"):
    """``(jax_graphs, port_graphs)``: the same ``synthetic_zinc`` or
    subgraph-count graphs (triangle target) from each package."""
    if source == "zinc":
        return (jx_datasets.synthetic_zinc(split, n_graphs=n_graphs),
                synthetic_zinc(split, n_graphs=n_graphs))
    kw = dict(n_graphs=n_graphs, n_lo=8, n_hi=14)
    return (jx_datasets.synthetic_subgraphcount(**kw),
            synthetic_subgraphcount(**kw))


def _models(L=2, H=32, rng=None):
    """The JAX ``SpModel("I2GNN")`` (seeded BatchNorm statistics where
    ``rng`` is given) and the port's with its weights; their keys."""
    kw = dict(num_layer=L, hiddim=H, outlayer=2,
              mlp={**MLPD, "numlayer": 2})
    jm = jx_make_sp_model("I2GNN", **kw)
    if rng is not None:
        randomize_bn(jm, rng)
    pm = make_sp_model("I2GNN", device="cpu", **kw)
    load_jax_params(pm, jax_params(jm))
    keys = jx_keys(jm)
    assert keys == parse_precomputekey(pm) == [KEY3]
    return jm, pm, keys


def _loaders(keys, source, n_graphs, bs, split="train", **kw):
    """A JAX loader and the port's over the same graphs, through
    ``I2Sampler(hop=3)`` (``workers=1``: the JAX loader's threads would
    grow shared buckets in thread order)."""
    jgs, pgs = _graphs(source, n_graphs, split)
    jpre = JxSppretransform(partial(JxI2Sampler, hop=3), [""], keys)
    pre = Sppretransform(partial(I2Sampler, hop=3), [""], keys)
    jdl = JxSpDataloader([jpre(g) for g in jgs], bs, keys,
                         device_put=False, prefetch=0, workers=1, **kw)
    pdl = SpDataloader([pre(g) for g in pgs], bs, keys, backward=True, **kw)
    return jdl, pdl


def test_load_jax_params_carries_the_i2gnn_weights():
    """Every parameter and buffer of the port's I2GNN has a JAX
    counterpart and takes its value: the two tuple encoders
    (``tuplefeat_encoder1/2``), ``lin_tupleinit2`` (transposed) and the
    layers; the port's seeded weights are replaced bit for bit."""
    jm, pm, _ = _models()
    params = jax_params(jm)
    state = {**dict(pm.named_parameters()), **dict(pm.named_buffers())}
    names = {_port_name(p)[0] for p in params}
    assert names == set(state)
    for name in ("data_encoder.tuplefeat_encoder1.weight",
                 "data_encoder.tuplefeat_encoder2.weight",
                 "lin_tupleinit2.weight", "lin_tupleinit2.bias"):
        assert name in names
    for path, ref in params.items():
        name, transpose = _port_name(path)
        np.testing.assert_array_equal(state[name].detach().numpy(),
                                      ref.T if transpose else ref)


@pytest.mark.parametrize("source", ["zinc", "count"])
def test_i2gnn_predictions_match_jax(rng, source):
    """``make_sp_model("I2GNN", device="cpu")`` in eval mode, with the
    JAX weights and seeded BatchNorm statistics, on one batch of 8 graphs
    (ZINC-like with edge features, or subgraph-count graphs whose
    adjacency has no values); the JAX forward under ``nnx.jit``, as its
    eval step runs it.  Tolerance 1e-4 abs on predictions of order 1."""
    jm, pm, keys = _models(rng=rng)
    jm.eval()
    pm.eval()
    jdl, pdl = _loaders(keys, source, 8, 8, "val")
    jb, pb = next(iter(jdl)), next(iter(pdl))
    ref = np.asarray(nnx.jit(lambda m, b: m(jx_to_dict(b)))(jm, jb))
    with torch.no_grad():
        out = pm(batch_to_sparse_dict(pb, ("",), CPU)).numpy()
    assert out.shape == ref.shape == (8, 1)
    assert np.abs(ref).max() > 0.1
    assert np.abs(out - ref).max() < 1e-4


@pytest.mark.parametrize("source", ["zinc", "count"])
def test_i2gnn_training_matches_jax(source):
    """Four AdamW steps at lr 1e-3 through the port's
    ``make_sparse_steps`` and the body of the JAX package's train step
    (returning the gradients as well), from the same weights, on
    shuffled batches of 8 of 16 graphs.

    - The first step's gradients: every parameter's (the tuple encoders',
      ``lin_tupleinit2``'s, and the edge embedding's on ZINC-like graphs,
      which flows through K1's dA role) within 2e-4 of its largest entry;
      the biases that feed a BatchNorm are left out, their gradients
      being rounding noise on both sides.
    - Per-step losses: 1e-5 relative.
    - Final parameters and BatchNorm statistics: 1e-5 abs + 1e-5
      relative, the BatchNorm-fed biases and those norms' running means
      held instead to AdamW's 1.05 * lr a step on each side, and at most
      1 in 1,000 elements of another tensor likewise
      (``tests/test_torch_subgraph_models.py``'s bounds)."""
    STEPS, LR = 4, 1e-3
    jm, pm, keys = _models()
    start = jax_params(jm)
    jdl, pdl = _loaders(keys, source, 16, 8, shuffle=True, drop_last=True,
                        seed=3)
    for dl in (jdl, pdl):     # settle the shape buckets: one JAX compile
        list(dl)
    jopt = jx_training.make_optimizer(jm, LR)
    pstep, _ = training.make_sparse_steps()
    popt = training.make_optimizer(pm, LR)
    jm.train()
    pm.train()

    @nnx.jit
    def jstep(model, optimizer, batch):
        def loss_fn(model):
            pred = model(jx_to_dict(batch))
            return jx_training.masked_l1_loss(pred, batch["y"],
                                              batch["graph_mask"])

        loss, grads = nnx.value_and_grad(loss_fn)(model)
        optimizer.update(model, grads)
        return loss, grads

    def batches(dl):
        while True:
            yield from dl

    params = dict(pm.named_parameters())
    noisy = bn_fed_biases(pm)
    jl, pl = [], []
    for i, jb, pb in zip(range(STEPS), batches(jdl), batches(pdl)):
        loss, jg = jstep(jm, jopt, jb)
        jl.append(float(loss))
        pl.append(float(pstep(pm, popt, pb)))
        if i:
            continue
        checked = set()
        for path, g in nnx.to_flat_state(jg):
            name, transpose = _port_name(path)
            if name in noisy:
                continue
            g = np.asarray(g.get_value())
            g = g.T if transpose else g
            grad = params[name].grad
            if grad is None:      # a parameter the model does not use
                assert not np.any(g), name
                continue
            assert maxrel(grad.numpy(), g) < 2e-4, name
            checked.add(name)
        want = {"data_encoder.tuplefeat_encoder1.weight",
                "data_encoder.tuplefeat_encoder2.weight",
                "lin_tupleinit2.weight"}
        if source == "zinc":
            want.add("data_encoder.ea_encoder.weight")
        assert want <= checked
        for name in want:
            assert np.abs(params[name].grad.numpy()).max() > 0, name
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-5 * np.abs(jl)), (pl, jl)

    targets = dict(params)
    targets.update(pm.named_buffers())
    for path, ref in jax_params(jm).items():
        name, transpose = _port_name(path)
        got = targets[name].detach().numpy()
        ref = ref.T if transpose else ref
        init = start[path].T if transpose else start[path]
        if name in params and not np.array_equal(ref, init):
            assert not np.array_equal(got, init), f"{name} is stuck"
        assert np.abs(got - ref).max() <= 2 * STEPS * 1.05 * LR, name
        if name not in noisy:
            off = ~np.isclose(got, ref, rtol=1e-5, atol=1e-5)
            assert off.sum() <= off.size // 1000, name


def test_recalibrate_batchnorm_matches_jax():
    """``recalibrate_batchnorm`` over three batches of 8 graphs sets every
    BatchNorm's running statistics to the mean of the batches' statistics,
    as the JAX function does: 1e-5 abs + 1e-5 relative against JAX's
    (f32 statistics of the same activations, summed in another order);
    the norms' momentum and mode come back as they were, and it returns
    the number of batches."""
    jm, pm, keys = _models()
    jdl, pdl = _loaders(keys, "zinc", 24, 8)
    jbs, pbs = list(jdl), list(pdl)
    jm.eval()
    pm.eval()
    n_j = jx_recalibrate(jm, jbs, nnx.jit(lambda m, b: m(jx_to_dict(b))))
    n_p = recalibrate_batchnorm(
        pm, pbs, lambda m, b: m(batch_to_sparse_dict(b, ("",), CPU)))
    assert n_j == n_p == 3
    assert not pm.training and all(not m.training for m in pm.modules())
    bufs = dict(pm.named_buffers())
    moved = 0
    for path, ref in jax_params(jm).items():
        name, _ = _port_name(path)
        if name.endswith((".mean", ".var")):
            got = bufs[name].numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            moved += int(not np.allclose(ref, 0.0 if name.endswith(
                ".mean") else 1.0))
    assert moved > 0
    momenta = {m.momentum for m in pm.modules() if hasattr(m, "momentum")}
    assert momenta == {MLPD.get("normparam", 0.1)}


def test_sppredictor_serves_i2gnn():
    """``SpPredictor(model, partial(I2Sampler, hop=3), keys,
    device="cpu")`` serves raw graphs in input order, in batches: the
    predictions of 12 graphs served in batches of 8 equal, within 1e-5
    abs, the model's on one batch of the 12, and a reordered request
    gives the same rows reordered."""
    _, pm, keys = _models()
    graphs = synthetic_zinc("val", n_graphs=12)
    pred = SpPredictor(pm, partial(I2Sampler, hop=3), keys, batch_size=8,
                       device="cpu")
    out = pred(graphs)
    assert out.shape == (12, 1) and np.isfinite(out).all()
    whole = SpPredictor(pm, partial(I2Sampler, hop=3), keys, batch_size=12,
                        device="cpu")(graphs)
    assert np.abs(out - whole).max() < 1e-5
    perm = np.random.default_rng(1).permutation(12)
    again = pred([graphs[i] for i in perm])
    assert np.abs(again - out[perm]).max() < 1e-5
