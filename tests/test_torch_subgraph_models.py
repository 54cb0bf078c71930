"""The subgraph conv family's models in sparse mode against the JAX
package, on the CPU: ``make_sp_model(conv, device="cpu")`` for SSWL,
DSSGNN, GNNAK, SUN and PPGN, with the JAX weights carried across by
``weights.load_jax_params``: predictions on collated batches, the
gradient of every parameter (the edge embedding's among them), and a
short AdamW trajectory per conv.  The operators and layers under them:
``tests/test_torch_subgraph_convs.py``.

Models of 2 layers x 32 on a few ``synthetic_zinc`` graphs; inputs and
norm statistics come from numpy seeds.  Each test states its tolerance.
"""

from functools import partial

import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import SpDataloader as JxSpDataloader
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import parse_precomputekey as jx_keys
from pygho_tpu.models import make_sp_model as jx_make_sp_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import parse_precomputekey
from pygho_tpu_torch.models import make_sp_model, training
from pygho_tpu_torch.weights import load_jax_params
from test_torch_subgraph_convs import (CPU, MLPD, _port_name, bn_fed_biases,
                                       jax_params, maxrel, randomize_bn)

CONVS = ["SSWL", "DSSGNN", "GNNAK", "SUN", "PPGN"]


def _models(conv, L=2, H=32, rng=None):
    """The JAX ``SpModel`` (seeded non-identity BatchNorm statistics where
    ``rng`` is given) and the port's with its weights; their keys."""
    kw = dict(num_layer=L, hiddim=H, outlayer=2,
              mlp={**MLPD, "numlayer": 2})
    jm = jx_make_sp_model(conv, **kw)
    if rng is not None:
        randomize_bn(jm, rng)
    pm = make_sp_model(conv, device="cpu", **kw)
    load_jax_params(pm, jax_params(jm))
    keys = jx_keys(jm)
    assert parse_precomputekey(pm) == keys
    return jm, pm, keys


def _loaders(keys, n_graphs, bs, split="train", **kw):
    """A JAX loader and the port's over the same graphs (``workers=1``:
    the JAX loader's thread pool would grow shared buckets in thread
    order)."""
    jpre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], keys)
    jdl = JxSpDataloader([jpre(g) for g in jx_synthetic_zinc(
        split, n_graphs=n_graphs)], bs, keys, device_put=False, prefetch=0,
        workers=1, **kw)
    pdl = SpDataloader([pre(g) for g in synthetic_zinc(
        split, n_graphs=n_graphs)], bs, keys, backward=True, **kw)
    return jdl, pdl


@pytest.mark.parametrize("conv", CONVS)
def test_sp_model_predictions_match_jax(rng, conv):
    """``make_sp_model(conv, device="cpu")`` in eval mode, with the JAX
    weights and seeded BatchNorm statistics, on one collated batch of 8
    ``synthetic_zinc("val")`` graphs (the JAX forward under ``nnx.jit``,
    as its eval step runs it).  Tolerance 1e-4 abs on predictions of
    order 1: f32 through two layers and the readout."""
    jm, pm, keys = _models(conv, rng=rng)
    jm.eval()
    pm.eval()
    jdl, pdl = _loaders(keys, 8, 8, "val")
    jb, pb = next(iter(jdl)), next(iter(pdl))
    ref = np.asarray(nnx.jit(lambda m, b: m(jx_to_dict(b)))(jm, jb))
    with torch.no_grad():
        out = pm(batch_to_sparse_dict(pb, ("",), CPU)).numpy()
    assert out.shape == ref.shape == (8, 1)
    assert np.abs(ref).max() > 0.1
    assert np.abs(out - ref).max() < 1e-4


@pytest.mark.parametrize("conv", CONVS)
def test_training_matches_jax(conv):
    """Four AdamW steps at lr 1e-3 through the port's
    ``make_sparse_steps`` and the body of the JAX package's (its
    ``nnx.value_and_grad`` and ``optimizer.update`` under ``nnx.jit``,
    returning the gradients as well), from the same weights, on shuffled
    batches of 8 of 16 graphs (parity bar 3, cut to four steps a conv).

    - The first step's gradients: every parameter's, the edge
      embedding's (``data_encoder.ea_encoder``) among them, which for SSWL
      flows through the cross key's dX role as well, within 2e-4 of its
      largest entry (sums in another order through two layers' forward
      and backward); the biases that feed a BatchNorm are left out, their
      gradients being rounding noise on both sides.
    - Per-step losses: 1e-5 relative.
    - Final parameters and BatchNorm statistics: 1e-5 abs + 1e-5
      relative, with two kinds of element held instead to what AdamW
      allows an element whose gradients are rounding noise, 1.05 * lr a
      step on each side (``tests/test_torch_training.py``'s bound): the
      biases that feed a BatchNorm and those norms' running means (their
      gradients are 0 in exact arithmetic), and at most 1 in 1,000
      elements of any other tensor, whose gradient cancels to rounding
      level in some step, so that AdamW's normalisation turns the two
      sides' rounding into steps that differ (1 of 3,072 to 14,336
      elements of a few weights of GNNAK and SUN).  A parameter that
      JAX's run moves must move in the port's."""
    STEPS, LR = 4, 1e-3
    jm, pm, keys = _models(conv)
    start = jax_params(jm)
    jdl, pdl = _loaders(keys, 16, 8, shuffle=True, drop_last=True, seed=3)
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
        assert checked <= set(params) - noisy
        if conv != "PPGN":        # PPGN reads no edge values
            assert "data_encoder.ea_encoder.weight" in checked
            assert np.abs(params["data_encoder.ea_encoder.weight"].grad
                          .numpy()).max() > 0
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-5 * np.abs(jl)), (pl, jl)

    targets = dict(params)
    targets.update(pm.named_buffers())
    checked = set()
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
        checked.add(name)
    assert checked == set(targets)
