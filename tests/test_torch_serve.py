"""The slice end to end on the CPU: the port's ``SpPredictor`` serving
NGNN-SS against the JAX ``SpPredictor`` (``build_plans=False``), with the
JAX weights carried across; plus the port's package rules (no JAX
imported, no quiet CPU fallback).

Before the weights cross over, the JAX model's BatchNorm statistics are
re-estimated on the requests' batches (so the activations are of order 1)
and then perturbed with seeded numpy values (so eval-mode normalisation
is not the identity and a wrong mapping shows).  Tolerance 1e-4 abs on
predictions of order 1: f32 on both sides, sums taken in another order
through up to six layers."""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax.numpy as jnp
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
from pygho_tpu.honn import utils as jx_utils
from pygho_tpu.models import SpPredictor as JxSpPredictor
from pygho_tpu.models import make_sp_model as jx_make_sp_model

from pygho_tpu_torch.hodata import KhopSampler, synthetic_zinc
from pygho_tpu_torch.honn import parse_precomputekey
from pygho_tpu_torch.models import SpPredictor, make_sp_model
from pygho_tpu_torch.weights import load_jax_params

REPO = Path(__file__).resolve().parent.parent
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
TOL = 1e-4


def _jax_model(num_layer, hiddim, graphs, rng):
    """The JAX model with its BatchNorm statistics re-estimated on
    ``graphs`` and then perturbed from ``rng``; returns it and its keys."""
    jm = jx_make_sp_model("NGNN", num_layer=num_layer, hiddim=hiddim,
                          mlp=dict(MLPD))
    keys = jx_keys(jm)
    pre = JxSppretransform(partial(JxKhopSampler, hop=3), [""], keys)
    datas = [pre(g) for g in graphs]
    dl = JxSpDataloader(datas, 8, keys, device_put=False, prefetch=0)
    jx_utils.recalibrate_batchnorm(jm, list(dl),
                                   lambda m, b: m(jx_to_dict(b)))
    for _, mod in nnx.iter_graph(jm):
        if isinstance(mod, jx_utils.BatchNorm):
            d = mod.num_features
            std = np.sqrt(np.asarray(mod.var[...]))
            mod.mean[...] = mod.mean[...] + jnp.asarray(
                rng.normal(0, 0.3, d) * std, jnp.float32)
            mod.var[...] = mod.var[...] * jnp.asarray(
                rng.uniform(0.5, 2.0, d), jnp.float32)
            mod.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, d),
                                         jnp.float32)
            mod.bias[...] = jnp.asarray(rng.normal(0, 0.2, d), jnp.float32)
    return jm, keys


@pytest.mark.parametrize("num_layer,hiddim", [(2, 16), (6, 128)])
def test_sp_predictor_matches_jax(rng, num_layer, hiddim):
    jx_graphs = jx_synthetic_zinc("val", n_graphs=20)
    jm, keys = _jax_model(num_layer, hiddim, jx_graphs, rng)
    ref = JxSpPredictor(jm, partial(JxKhopSampler, hop=3), keys,
                        batch_size=8, build_plans=False)(jx_graphs)

    pm = make_sp_model("NGNN", num_layer=num_layer, hiddim=hiddim,
                       mlp=dict(MLPD), device="cpu")
    assert parse_precomputekey(pm) == keys
    load_jax_params(pm, {path: np.asarray(var.get_value()) for path, var
                         in nnx.to_flat_state(nnx.state(jm))})
    predictor = SpPredictor(pm, partial(KhopSampler, hop=3), keys,
                            batch_size=8, device="cpu")
    graphs = synthetic_zinc("val", n_graphs=20)
    out = predictor(graphs)
    assert out.shape == ref.shape == (20, 1)
    assert np.abs(ref).max() > 0.1          # the check is not vacuous
    assert np.abs(out - ref).max() < TOL

    # order kept across calls that reuse the shape buckets
    idx = [17, 3, 11, 0, 19]
    again = predictor([graphs[i] for i in idx])
    assert np.abs(again - out[idx]).max() < 1e-5


def test_entry_points_need_a_device_choice():
    """With no card, the entry points raise unless the caller asks for
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sp_model("NGNN", num_layer=1, hiddim=8)
    m = make_sp_model("NGNN", num_layer=1, hiddim=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpPredictor(m, KhopSampler, parse_precomputekey(m))
    with pytest.raises(NotImplementedError):
        SpPredictor(m, KhopSampler, parse_precomputekey(m), num_workers=2,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        make_sp_model("NGNN", num_layer=1, hiddim=8, aggr="mean",
                      device="cpu")


def test_port_imports_nothing_of_jax():
    """Importing every module of the port, and chip_smoke, leaves neither
    JAX, flax nor pygho_tpu in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pygho_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(pygho_tpu_torch.__path__,\n"
        "                               'pygho_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'pygho_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
