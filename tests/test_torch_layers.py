"""The port's layers against the JAX package's, on the CPU, with the JAX
weights carried across by ``pygho_tpu_torch.weights.load_jax_params``.

Inputs and norm statistics come from numpy seeds.  Tolerance 1e-5 abs on
values of order 1: the same f32 arithmetic with sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import batch_to_sparse_dict as jx_to_dict
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.honn import conv as jx_conv
from pygho_tpu.honn import utils as jx_utils

from pygho_tpu_torch.hodata.loader import add_rowptr
from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn import utils as pt_utils
from pygho_tpu_torch.weights import load_jax_params

TOL = 1e-5
KEY = "X___X___1___A___0"
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
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


def _mask(rng, n):
    m = rng.random(n) < 0.7
    m[0] = True
    return m


def test_batchnorm_eval_and_masked_train(rng):
    d = 12
    jbn = jx_utils.BatchNorm(d, 0.1)
    randomize_bn(jbn, rng)
    pbn = pt_utils.BatchNorm(d, 0.1)
    load_jax_params(pbn, jax_params(jbn))
    x = rng.normal(1.0, 2.0, size=(50, d)).astype(np.float32)
    mask = _mask(rng, 50)
    # eval: running statistics
    jbn.use_running_average = True
    pbn.eval()
    ref = np.asarray(jbn(jnp.asarray(x), jnp.asarray(mask)))
    out = pbn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(out - ref).max() < TOL
    # train: statistics over the masked rows only, and the running update
    jbn.use_running_average = False
    pbn.train()
    ref = np.asarray(jbn(jnp.asarray(x), jnp.asarray(mask)))
    out = pbn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(out[mask] - ref[mask]).max() < TOL
    for name in ("mean", "var"):
        assert np.abs(getattr(pbn, name).numpy()
                      - np.asarray(getattr(jbn, name)[...])).max() < TOL
    # masked-out rows never reach the statistics
    x2 = x.copy()
    x2[~mask] = 1e6
    pbn2 = pt_utils.BatchNorm(d, 0.1).train()
    pbn3 = pt_utils.BatchNorm(d, 0.1).train()
    pbn2(torch.from_numpy(x), torch.from_numpy(mask))
    pbn3(torch.from_numpy(x2), torch.from_numpy(mask))
    assert torch.allclose(pbn2.mean, pbn3.mean)


@pytest.mark.parametrize("numlayer,tailact", [(1, True), (2, False),
                                              (3, True)])
@pytest.mark.parametrize("train", [False, True])
def test_mlp_matches(rng, numlayer, tailact, train):
    jm = jx_utils.MLP(16, 8 if not tailact else 16, numlayer, tailact,
                      rngs=nnx.Rngs(1), **MLPD)
    randomize_bn(jm, rng)
    pm = pt_utils.MLP(16, 8 if not tailact else 16, numlayer, tailact,
                      **GEN, **MLPD)
    load_jax_params(pm, jax_params(jm))
    if train:
        jm.train()
        pm.train()
    else:
        jm.eval()
        pm.eval()
    x = rng.normal(size=(40, 16)).astype(np.float32)
    mask = _mask(rng, 40)
    ref = np.asarray(jm(jnp.asarray(x), jnp.asarray(mask)))
    out = pm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(out[mask] - ref[mask]).max() < TOL


def test_load_jax_params_refuses_a_wrong_mapping(rng):
    jm = jx_utils.MLP(16, 16, 2, True, rngs=nnx.Rngs(1), **MLPD)
    pm = pt_utils.MLP(16, 16, 2, True, **GEN, **MLPD)
    params = jax_params(jm)
    load_jax_params(pm, params)
    w = params[("tail_lin", "kernel")]
    assert torch.equal(pm.tail_lin.weight, torch.tensor(w.T))
    with pytest.raises(KeyError):
        load_jax_params(pm, {**params, ("tail_lin", "extra"): w})
    with pytest.raises(KeyError):
        load_jax_params(pm, {k: v for k, v in params.items()
                             if k[-1] != "var"})
    with pytest.raises(ValueError):
        load_jax_params(pm, {**params, ("tail_lin", "bias"): w[0, :3]})


@pytest.mark.parametrize("train", [False, True])
def test_ngnnconv_matches(rng, train):
    from functools import partial

    D = 16
    pre = JxSppretransform(partial(JxKhopSampler, hop=2), [""], [KEY])
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=6)]
    batch = jx_collate_sparse(datas, [KEY], [""], 8)
    nt, ne = int(batch["num_tuples"]), int(batch["num_edges"])
    U = np.zeros((batch["tupleid"].shape[1], D), np.float32)
    V = np.zeros((batch["edge_index"].shape[1], D), np.float32)
    U[:nt] = rng.normal(size=(nt, D))
    V[:ne] = rng.normal(size=(ne, D))

    mlp = {**MLPD, "numlayer": 1, "tailact": True}    # SpModel's defaults
    jc = jx_conv.NGNNConv(D, D, "sum", "SS", mlp, rngs=nnx.Rngs(2))
    randomize_bn(jc, rng)
    pc = pt_conv.NGNNConv(D, D, "sum", "SS", mlp, **GEN)
    load_jax_params(pc, jax_params(jc))
    (jc.train if train else jc.eval)()
    pc.train(train)

    jd = jx_to_dict(batch)
    jX = jd["X"].__class__(jd["X"].indices, jnp.asarray(U), jd["X"].nnz,
                           jd["X"].sparse_shape)
    jA = jd["A"].__class__(jd["A"].indices, jnp.asarray(V), jd["A"].nnz,
                           jd["A"].sparse_shape)
    ref = np.asarray(jc(jA, jX, jd).values)

    pb = dict(batch)
    add_rowptr(pb, [KEY])
    pd = batch_to_sparse_dict(pb, ("",), torch.device("cpu"))
    pX = pd["X"].__class__(pd["X"].indices, torch.from_numpy(U),
                           pd["X"].nnz, pd["X"].sparse_shape)
    pA = pd["A"].__class__(pd["A"].indices, torch.from_numpy(V),
                           pd["A"].nnz, pd["A"].sparse_shape)
    out = pc(pA, pX, pd).values.detach().numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < TOL
    assert np.all(out[nt:] == 0)
