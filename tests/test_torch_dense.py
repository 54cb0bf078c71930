"""The dense ("DD") slice of the port against the JAX package, on the CPU:
K5 (``ChannelwiseBmm``, whose roles run their plain version here) against
the TPU kernel in interpret mode, ``mamamm``, ``MaskedTensor``'s
reductions, the masked BatchNorm at rank 3, the dense batches and loader,
``MaModel("PPGN")`` with the JAX weights carried across, ``MaPredictor``,
and a ten-step ``make_dense_steps`` trajectory.

Every input comes from a numpy seed; each test states its tolerance."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pygho_tpu.backend.mamamm import mamamm as jx_mamamm
from pygho_tpu.backend.matensor import MaskedTensor as JxMaskedTensor
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import MaDataloader as JxMaDataloader
from pygho_tpu.hodata.loader import Mapretransform as JxMapretransform
from pygho_tpu.hodata.ma_data import batch_to_dense_dict as jx_to_dict
from pygho_tpu.hodata.ma_data import collate_dense as jx_collate_dense
from pygho_tpu.hodata.ma_sampler import spdsampler as jx_spdsampler
from pygho_tpu.honn import utils as jx_utils
from pygho_tpu.kernels.channelwise_bmm import channelwise_bmm as jx_cw
from pygho_tpu.models import MaPredictor as JxMaPredictor
from pygho_tpu.models import make_ma_model as jx_make_ma_model
from pygho_tpu.models import training as jx_training

from pygho_tpu_torch.backend.mamamm import mamamm
from pygho_tpu_torch.backend.matensor import MaskedTensor
from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                    batch_to_dense_dict, collate_dense,
                                    spdsampler, synthetic_zinc)
from pygho_tpu_torch.honn import utils as pt_utils
from pygho_tpu_torch.kernels import channelwise_bmm as k5
from pygho_tpu_torch.models import (MaPredictor, make_dense_steps,
                                    make_ma_model, make_optimizer)
from pygho_tpu_torch.weights import load_jax_params

# the converged PPGN-dense configuration's MLPs (runs/converged/
# PPGN_dense.json, example/zinc_tpu.py:129)
MLPD = {"dp": 0.0, "norm": "bn", "act": "silu", "normparam": 0.185,
        "numlayer": 2, "tailact": True}
HOP = 4
# K5 against the TPU kernel: both sum k in ascending order with each
# product rounded, but XLA may fuse or reorder on the CPU; an f32 sum of n
# terms is exact to about n ulps of the sum of their magnitudes
CW_RTOL = 1e-5


def _flat(jm):
    """The JAX module's state flattened to numpy arrays by path."""
    return {path: np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(nnx.state(jm))}


def _randomize_bn(module, rng):
    """Seeded, non-identity BatchNorm parameters and statistics."""
    for _, mod in nnx.iter_graph(module):
        if isinstance(mod, jx_utils.BatchNorm):
            d = mod.num_features
            mod.mean[...] = jnp.asarray(rng.normal(0, 0.5, d), jnp.float32)
            mod.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, d), jnp.float32)
            mod.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, d),
                                         jnp.float32)
            mod.bias[...] = jnp.asarray(rng.normal(0, 0.2, d), jnp.float32)


def _masked(rng, shape, empty_graph=True):
    """f32 data of ``shape`` (b, n, n, d) and a (b, n, n) mask of graphs
    of random sizes, the last one all-masked where ``empty_graph``."""
    b, n = shape[:2]
    data = rng.normal(size=shape).astype(np.float32)
    sizes = rng.integers(1, n + 1, b)
    if empty_graph:
        sizes[-1] = 0
    node = np.arange(n)[None, :] < sizes[:, None]
    mask = node[:, :, None] & node[:, None, :]
    return data, mask


def _cw_tol(A, X):
    """CW_RTOL times the sum of the magnitudes of each output's terms."""
    return CW_RTOL * k5.cw_bmm_plain(torch.from_numpy(np.abs(A)),
                                     torch.from_numpy(np.abs(X))).numpy()


def test_cw_bmm_matches_the_tpu_kernel(rng):
    """K5's forward (plain version, through the raw wrapper) against
    ``channelwise_bmm`` in interpret mode at (3, 24, 24, 128)."""
    A = rng.normal(size=(3, 24, 24, 128)).astype(np.float32)
    X = rng.normal(size=(3, 24, 24, 128)).astype(np.float32)
    ref = np.asarray(jx_cw(jnp.asarray(A), jnp.asarray(X), True))
    out = k5.cw_bmm(k5.FWD, torch.from_numpy(A), torch.from_numpy(X))
    assert out.shape == (3, 24, 24, 128) and out.is_contiguous()
    assert np.all(np.abs(out.numpy() - ref) <= _cw_tol(A, X))


def test_cw_bmm_grads_match_the_tpu_kernel(rng):
    """``ChannelwiseBmm``'s dA and dX roles against ``jax.vjp`` of
    ``channelwise_bmm`` in interpret mode (whose ``_cw_bwd`` runs the TPU
    kernel on the swapped operands), at (3, 24, 24, 128)."""
    A, X, W = (rng.normal(size=(3, 24, 24, 128)).astype(np.float32)
               for _ in range(3))
    _, vjp = jax.vjp(lambda a, x: jx_cw(a, x, True), jnp.asarray(A),
                     jnp.asarray(X))
    dA_ref, dX_ref = (np.asarray(v) for v in vjp(jnp.asarray(W)))
    At = torch.from_numpy(A).requires_grad_()
    Xt = torch.from_numpy(X).requires_grad_()
    (k5.ChannelwiseBmm.apply(At, Xt) * torch.from_numpy(W)).sum().backward()
    XT, AT = (np.swapaxes(v, 1, 2) for v in (X, A))
    assert np.all(np.abs(At.grad.numpy() - dA_ref) <= _cw_tol(W, XT))
    assert np.all(np.abs(Xt.grad.numpy() - dX_ref) <= _cw_tol(AT, W))


def test_cw_bmm_strided_operands_and_refusals(rng):
    """A transposed view gives what its copy gives (the CUDA kernel reads
    views through their strides; here the plain version); the raw wrapper
    refuses a tensor that requires grad, a dtype other than f32 and
    operands of two shapes."""
    A = torch.from_numpy(rng.normal(size=(2, 5, 5, 3)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(2, 5, 5, 3)).astype(np.float32))
    assert torch.equal(k5.cw_bmm(k5.DA, A, X.transpose(1, 2)),
                       k5.cw_bmm(k5.DA, A, X.transpose(1, 2).contiguous()))
    with pytest.raises(RuntimeError, match="ChannelwiseBmm"):
        k5.cw_bmm(k5.FWD, A.clone().requires_grad_(), X)
    with torch.no_grad():
        k5.cw_bmm(k5.FWD, A.clone().requires_grad_(), X)
    with pytest.raises(TypeError):
        k5.cw_bmm(k5.FWD, A.double(), X.double())
    with pytest.raises(ValueError):
        k5.cw_bmm(k5.FWD, A, X[:, :4, :4])
    assert all(r.launches == 0 for r in k5.ROLES)   # no kernel on the CPU


@pytest.mark.parametrize("dim1,dim2", [(2, 1), (1, 1), (2, 2), (1, 2)])
def test_mamamm_matches_jax(rng, monkeypatch, dim1, dim2):
    """Every (dim1, dim2) variant goes through K5 once (its plain version
    on the CPU) and matches the JAX ``mamamm`` (an einsum on the CPU) to
    CW_RTOL of the terms' magnitudes; masked entries of the operands never
    count, and an all-masked graph gives 0."""
    calls = []
    plain = k5.cw_bmm_plain
    monkeypatch.setattr(k5, "cw_bmm_plain",
                        lambda a, x: calls.append(1) or plain(a, x))
    shape = (3, 9, 9, 16)
    a, am = _masked(rng, shape)
    b, bm = _masked(rng, shape, empty_graph=False)
    om = am | bm
    ref = jx_mamamm(JxMaskedTensor(jnp.asarray(a), jnp.asarray(am)), dim1,
                    JxMaskedTensor(jnp.asarray(b), jnp.asarray(bm)), dim2,
                    jnp.asarray(om))
    out = mamamm(MaskedTensor(torch.from_numpy(a), torch.from_numpy(am)),
                 dim1, MaskedTensor(torch.from_numpy(b), torch.from_numpy(bm)),
                 dim2, torch.from_numpy(om))
    assert calls == [1]
    assert np.array_equal(out.mask.numpy(), om)
    fa = np.where(am[..., None], a, 0)
    fb = np.where(bm[..., None], b, 0)
    fa = fa if dim1 == 2 else np.swapaxes(fa, 1, 2)
    fb = fb if dim2 == 1 else np.swapaxes(fb, 1, 2)
    assert np.all(np.abs(out.data.numpy() - np.asarray(ref.data))
                  <= _cw_tol(fa, fb))
    assert np.all(out.data.numpy()[-1] == 0)     # the all-masked graph


def test_mamamm_einsum_path_matches_jax(rng):
    """A product that is not channel-wise, dense node message passing
    ``A (b, n, n, d) x X (b, n, d)`` over ``(2, 1)``, stays an einsum and
    matches the JAX one; 1e-5 abs on sums of nine products of order 1."""
    a, am = _masked(rng, (3, 9, 9, 4))
    x = rng.normal(size=(3, 9, 4)).astype(np.float32)
    xm = am.any(2)
    ref = jx_mamamm(JxMaskedTensor(jnp.asarray(a), jnp.asarray(am)), 2,
                    JxMaskedTensor(jnp.asarray(x), jnp.asarray(xm)), 1,
                    jnp.asarray(xm))
    out = mamamm(MaskedTensor(torch.from_numpy(a), torch.from_numpy(am)), 2,
                 MaskedTensor(torch.from_numpy(x), torch.from_numpy(xm)), 1,
                 torch.from_numpy(xm))
    assert out.data.shape == (3, 9, 4)
    assert np.abs(out.data.numpy() - np.asarray(ref.data)).max() < 1e-5


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_maskedtensor_reductions_match_jax(rng, op):
    """``sum``, ``mean``, ``max`` and ``min`` over dim 2 and over dims
    (1, 2), with an all-masked graph (0, not NaN or inf), and their
    gradients, ties included (``max``/``min`` split a gradient evenly
    among tied entries, as JAX does).  Values within 1e-6 of the sum (the
    mean for ``mean``) of the magnitudes reduced: one f32 sum of at most
    81 values in another order; gradients, of order 1, within 1e-6 abs."""
    data, mask = _masked(rng, (3, 9, 9, 5))
    data[0, 0, :2] = 3.0           # a tie along dim 2
    W2 = rng.normal(size=(3, 9, 5)).astype(np.float32)
    for dims, W in ((2, W2), ((1, 2), W2[:, 0])):
        ref, vjp = jax.vjp(
            lambda d: getattr(JxMaskedTensor(d, jnp.asarray(mask)), op)(
                dims).data, jnp.asarray(data))
        ref_mask = getattr(JxMaskedTensor(jnp.asarray(data),
                                          jnp.asarray(mask)), op)(dims).mask
        (gref,) = vjp(jnp.asarray(W))
        t = torch.from_numpy(data).requires_grad_()
        out = getattr(MaskedTensor(t, torch.from_numpy(mask)), op)(dims)
        (out.data * torch.from_numpy(W)).sum().backward()
        assert np.array_equal(out.mask.numpy(), np.asarray(ref_mask))
        assert np.isfinite(out.data.detach().numpy()).all()
        mag = getattr(MaskedTensor(torch.from_numpy(np.abs(data)),
                                   torch.from_numpy(mask)),
                      "mean" if op == "mean" else "sum")(dims).data.numpy()
        assert np.all(np.abs(out.data.detach().numpy() - np.asarray(ref))
                      <= 1e-6 * mag)
        assert np.all(out.data.detach().numpy()[-1] == 0)
        assert np.abs(t.grad.numpy() - np.asarray(gref)).max() < 1e-6


def test_batchnorm_rank3_mask_matches_jax(rng):
    """The masked BatchNorm on a (b, n, n, d) tensor with a (b, n, n)
    mask, in train mode: statistics over the valid tuples only; 1e-5 abs
    on values of order 1."""
    d = 8
    x, mask = _masked(rng, (3, 7, 7, d))
    x = x * 2.0 + 1.0
    jbn = jx_utils.BatchNorm(d, 0.185)
    pbn = pt_utils.BatchNorm(d, 0.185).train()
    ref = np.asarray(jbn(jnp.asarray(x), jnp.asarray(mask)))
    out = pbn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(out[mask] - ref[mask]).max() < 1e-5
    for name in ("mean", "var"):
        assert np.abs(getattr(pbn, name).numpy()
                      - np.asarray(getattr(jbn, name)[...])).max() < 1e-5
    x2 = np.where(mask[..., None], x, 1e6).astype(np.float32)
    pbn2 = pt_utils.BatchNorm(d, 0.185).train()
    pbn2(torch.from_numpy(x2), torch.from_numpy(mask))
    assert torch.allclose(pbn2.mean, pbn.mean) \
        and torch.allclose(pbn2.var, pbn.var)


def _datas(port, split="train", n_graphs=16):
    if port:
        pre = Mapretransform(partial(spdsampler, hop=HOP))
        return [pre(g) for g in synthetic_zinc(split, n_graphs=n_graphs)]
    pre = JxMapretransform(partial(jx_spdsampler, hop=HOP))
    return [pre(g) for g in jx_synthetic_zinc(split, n_graphs=n_graphs)]


def _same_batch(pb, jb):
    assert pb.keys() == jb.keys()
    for k in jb:
        assert pb[k].dtype == np.asarray(jb[k]).dtype, k
        assert np.array_equal(pb[k], np.asarray(jb[k])), k


def test_collate_dense_matches_jax():
    """Six graphs padded to eight: every array, dtype and mask equal, and
    the shared bucket of n grown the same way."""
    pb_, jb_ = {}, {}
    pb = collate_dense(_datas(True, "val", 6), ("",), num_graphs=8,
                       buckets=pb_)
    jb = jx_collate_dense(_datas(False, "val", 6), ("",), num_graphs=8,
                          buckets=jb_)
    _same_batch(pb, jb)
    assert pb_ == jb_ and pb["x"].shape[1] == 32
    assert not pb["X_mask"][6:].any() and pb["graph_mask"].sum() == 6


@pytest.mark.parametrize("seed", [0, 7])
def test_ma_dataloader_matches_jax(seed):
    """Shuffled with ``drop_last``, two epochs: the port's loader gives
    the JAX loader's batches, array for array."""
    pdl = MaDataloader(_datas(True, n_graphs=20), 8, shuffle=True,
                       drop_last=True, seed=seed)
    jdl = JxMaDataloader(_datas(False, n_graphs=20), 8, shuffle=True,
                         drop_last=True, seed=seed, device_put=False,
                         prefetch=0)
    assert len(pdl) == len(jdl) == 2
    for _ in range(2):
        pbs, jbs = list(pdl), list(jdl)
        assert len(pbs) == len(jbs) == 2
        for pb, jb in zip(pbs, jbs):
            _same_batch(pb, jb)


def _models(L, H, rng, **kw):
    jm = jx_make_ma_model("PPGN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                          seed=3, **kw)
    _randomize_bn(jm, rng)
    pm = make_ma_model("PPGN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                       device="cpu", **kw)
    load_jax_params(pm, _flat(jm))
    return jm, pm


@pytest.mark.parametrize("train,pools", [
    (False, dict(npool="sum", lpool="mean", outlayer=4)),
    (True, dict(npool="sum", lpool="mean", outlayer=4)),
    (False, dict()),                      # MaModel's defaults: mean, max
])
def test_mamodel_ppgn_matches_jax(rng, train, pools):
    """``MaModel("PPGN")`` 2 x 16 on six graphs padded to eight (two
    all-masked graphs), with the JAX weights and seeded BatchNorm
    statistics carried across; in eval mode and in train mode (batch
    statistics over the valid tuples, and the running statistics after
    the step).  1e-5 abs on predictions of order 1: f32 on both sides,
    sums in another order through two layers; running statistics, up to
    about 50, within 1e-5 abs + 1e-5 relative."""
    jm, pm = _models(2, 16, rng, **pools)
    jb = jx_collate_dense(_datas(False, "val", 6), ("",), num_graphs=8)
    pb = collate_dense(_datas(True, "val", 6), ("",), num_graphs=8)
    if train:
        jm.train()
        pm.train()
    else:
        jm.eval()
        pm.eval()
    ref = np.asarray(jm(jx_to_dict(jb)))
    with torch.no_grad():
        out = pm(batch_to_dense_dict(pb, ("",), torch.device("cpu")))
    assert out.shape == (8, 1) and np.isfinite(out.numpy()).all()
    assert np.abs(out.numpy() - ref).max() < 1e-5
    if train:
        targets = dict(pm.named_buffers())
        for path, val in _flat(jm).items():
            name = ".".join(str(p) for p in path)
            if name in targets:
                assert np.allclose(targets[name].numpy(), val, rtol=1e-5,
                                   atol=1e-5), name


def test_ma_predictor_matches_jax(rng):
    """The port's ``MaPredictor`` against the JAX one on 13 raw graphs in
    batches of 8: the same predictions in input order, within 1e-5 abs."""
    jm, pm = _models(2, 16, rng, npool="sum", lpool="mean", outlayer=4)
    graphs = jx_synthetic_zinc("val", n_graphs=13)
    ref = JxMaPredictor(jm, partial(jx_spdsampler, hop=HOP),
                        batch_size=8)(graphs)
    pred = MaPredictor(pm, partial(spdsampler, hop=HOP), batch_size=8,
                       device="cpu")
    out = pred(synthetic_zinc("val", n_graphs=13))
    assert out.shape == (13, 1)
    assert np.abs(out - ref).max() < 1e-5
    again = pred(pred.preprocess(synthetic_zinc("val", n_graphs=13))[5:9])
    assert np.array_equal(again, pred(synthetic_zinc("val", n_graphs=13)
                                      [5:9]))


def test_dense_training_trajectory_matches_jax():
    """PPGN-DD 2 x 16, 16 graphs in shuffled batches of 8, ten AdamW steps
    at lr 1e-3 through the port's ``make_dense_steps`` and the JAX
    package's, from the same weights (parity bar 3).  Per-step losses
    within 1e-4 relative: f32 on both sides, sums in another order
    through forward, backward and ten optimizer steps."""
    L, H, G, BS, STEPS, LR = 2, 16, 16, 8, 10, 1e-3
    cfg = dict(npool="sum", lpool="mean", outlayer=4)
    jm = jx_make_ma_model("PPGN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                          **cfg)
    pm = make_ma_model("PPGN", num_layer=L, hiddim=H, mlp=dict(MLPD),
                       device="cpu", **cfg)
    load_jax_params(pm, _flat(jm))
    jdl = JxMaDataloader(_datas(False, n_graphs=G), BS, shuffle=True,
                         drop_last=True, seed=3, device_put=False,
                         prefetch=0)
    pdl = MaDataloader(_datas(True, n_graphs=G), BS, shuffle=True,
                       drop_last=True, seed=3)
    jstep, _ = jx_training.make_dense_steps()
    jopt = jx_training.make_optimizer(jm, LR)
    pstep, peval = make_dense_steps()
    popt = make_optimizer(pm, LR)
    jm.train()
    pm.train()

    def batches(dl):
        while True:
            yield from dl

    jl, pl = [], []
    for jb, pb, _ in zip(batches(jdl), batches(pdl), range(STEPS)):
        jl.append(float(jstep(jm, jopt, jb)))
        pl.append(float(pstep(pm, popt, pb)))
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.abs(pl - jl) <= 1e-4 * np.abs(jl)), (pl, jl)
    assert len(set(pl.tolist())) == STEPS       # the model does move
    pm.eval()
    s, c = peval(pm, next(iter(pdl))).tolist()
    assert c == BS and np.isfinite(s)


def test_dense_refusals():
    """What the slice does not port raises, loudly."""
    with pytest.raises(NotImplementedError):
        make_ma_model("NGNN", device="cpu")
    with pytest.raises(NotImplementedError):
        make_ma_model("PPGN", num_layer=1, hiddim=8, mode="SD", device="cpu")
    with pytest.raises(NotImplementedError):
        make_ma_model("PPGN", num_layer=1, hiddim=8, remat=True,
                      device="cpu")
    with pytest.raises(NotImplementedError):
        MaDataloader([], 8, denseadj=False)
    t = MaskedTensor(torch.zeros(1, 2, 2, 3), torch.ones(1, 2, 2,
                                                          dtype=torch.bool))
    for call in (lambda: t.diag([1, 2]), lambda: t.catvalue(t, True),
                 lambda: t.unpooling(1, t)):
        with pytest.raises(NotImplementedError):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_ma_model("PPGN", num_layer=1, hiddim=8)
