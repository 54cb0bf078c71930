"""K1 forward (``pygho_tpu_torch/kernels/spspmm_sum.py``) against the JAX
package, on the CPU: the port's ``spspmm`` runs the kernel's plain version
here and is held against the JAX ``spspmm`` (XLA path) and against the
TPU kernel itself (``fused_spspmm_strip``, interpret mode).

Tolerance 1e-5 abs: the same f32 products on values of order 1, summed
over a handful of triples per row in another order."""

import copy
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.backend.sptensor import SparseTensor as JxSparseTensor
from pygho_tpu.backend.spspmm import spspmm as jx_spspmm
from pygho_tpu.hodata.datasets import synthetic_zinc as jx_synthetic_zinc
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_data import collate_sparse as jx_collate_sparse
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler
from pygho_tpu.kernels.strip_spspmm import (autotune_strip_geoms,
                                            build_spspmm_strip_plans,
                                            fused_spspmm_strip)

from pygho_tpu_torch.backend.sptensor import SparseTensor
from pygho_tpu_torch.backend.spspmm import spspmm
from pygho_tpu_torch.hodata.loader import add_rowptr
from pygho_tpu_torch.kernels import _build, spspmm_sum

KEY = "X___X___1___A___0"
TOL = 1e-5


def _batch(n_graphs, hop=3):
    pre = JxSppretransform(partial(JxKhopSampler, hop=hop), [""], [KEY])
    datas = [pre(g) for g in jx_synthetic_zinc("val", n_graphs=n_graphs)]
    return jx_collate_sparse(datas, [KEY], [""], n_graphs)


def _port_spspmm(batch, U, V):
    b = copy.deepcopy(batch)
    add_rowptr(b, [KEY])
    n_pad = b["x"].shape[0]
    X = SparseTensor(torch.from_numpy(b["tupleid"]).long(),
                     torch.from_numpy(U), int(b["num_tuples"]),
                     (n_pad, n_pad))
    A = SparseTensor(torch.from_numpy(b["edge_index"]).long(),
                     torch.from_numpy(V), int(b["num_edges"]),
                     (n_pad, n_pad))
    out = spspmm(X, 1, A, 0, "sum", acd=torch.from_numpy(b[f"{KEY}___acd"]),
                 rowptr=torch.from_numpy(b[f"{KEY}___rowptr"]), tarX=X)
    return out.values.numpy()


def _uv(rng, batch, D):
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    U = rng.normal(size=(nt, D)).astype(np.float32)
    V = rng.normal(size=(ne, D)).astype(np.float32)
    U[int(batch["num_tuples"]):] = 0     # padded rows are zero, as in
    V[int(batch["num_edges"]):] = 0      # the model
    return U, V


@pytest.mark.parametrize("D", [128, 16, 5])
def test_spspmm_matches_jax_xla(rng, D):
    batch = _batch(8)
    U, V = _uv(rng, batch, D)
    n_pad = batch["x"].shape[0]
    X = JxSparseTensor(jnp.asarray(batch["tupleid"]), jnp.asarray(U),
                       jnp.asarray(batch["num_tuples"]), (n_pad, n_pad))
    A = JxSparseTensor(jnp.asarray(batch["edge_index"]), jnp.asarray(V),
                       jnp.asarray(batch["num_edges"]), (n_pad, n_pad))
    ref = np.asarray(jx_spspmm(X, 1, A, 0, "sum",
                               acd=jnp.asarray(batch[f"{KEY}___acd"]),
                               tarX=X).values)
    out = _port_spspmm(batch, U, V)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < TOL
    assert np.all(out[int(batch["num_tuples"]):] == 0)


def test_spspmm_matches_tpu_strip_kernel(rng):
    """D = 128 on a 4-graph batch against the TPU kernel in interpret
    mode, on plans built the way the JAX loader builds them."""
    batch = _batch(4)
    acd = batch[f"{KEY}___acd"]
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    geoms = autotune_strip_geoms(acd, nt, ne, nt, D=128, probe=False)
    plans = build_spspmm_strip_plans(acd, nt, ne, nt, geoms)
    U, V = _uv(rng, batch, 128)
    ref = np.asarray(fused_spspmm_strip(jnp.asarray(U), jnp.asarray(V),
                                        *plans, True))[:nt]
    out = _port_spspmm(batch, U, V)
    assert np.abs(out - ref).max() < TOL


def _loop_oracle(U, V, acd, out_rows):
    out = np.zeros((out_rows, U.shape[1]), np.float64)
    for a, c, d in acd.T:
        out[a] += U[c].astype(np.float64) * V[d]
    return out


@pytest.mark.parametrize("D", [128, 16, 3])
def test_wrapper_edge_cases(rng, D):
    """Empty rows, one row with many triples and a tail of padded rows,
    against a float64 loop."""
    out_rows, u_rows, v_rows = 40, 30, 20
    rows = np.concatenate([np.full(300, 7), rng.integers(0, 30, 60)])
    rows = rows[(rows != 3) & (rows != 11)]           # rows 3, 11 empty
    a = np.sort(rows)
    acd = np.stack([a, rng.integers(0, u_rows, a.size),
                    rng.integers(0, v_rows, a.size)]).astype(np.int32)
    rowptr = np.zeros(out_rows + 1, np.int32)
    rowptr[1:] = np.cumsum(np.bincount(a, minlength=out_rows))
    U = rng.normal(size=(u_rows, D)).astype(np.float32)
    V = rng.normal(size=(v_rows, D)).astype(np.float32)
    before = spspmm_sum.FWD.launches
    out = spspmm_sum.spspmm_sum(torch.from_numpy(U), torch.from_numpy(V),
                                torch.from_numpy(acd),
                                torch.from_numpy(rowptr)).numpy()
    assert spspmm_sum.FWD.launches == before     # the CPU runs no kernel
    ref = _loop_oracle(U, V, acd, out_rows)
    # row 7 sums 300+ products: f32 rounding grows with the count
    assert np.abs(out - ref).max() < 1e-4
    assert np.all(out[[3, 11]] == 0) and np.all(out[30:] == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    U, V = torch.zeros(4, 8), torch.zeros(3, 8)
    acd = torch.zeros(3, 2, dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 2, 2, 2], dtype=torch.int32)
    ok = spspmm_sum.spspmm_sum(U, V, acd, rowptr)
    assert ok.shape == (4, 8)
    bad = [
        (U.double(), V.double(), acd, rowptr),            # dtype
        (U, torch.zeros(3, 4), acd, rowptr),              # D mismatch
        (U, V, acd.long(), rowptr),                       # index dtype
        (U, V, acd, rowptr.long()),
        (torch.zeros(8, 4).t(), V, acd, rowptr),          # not contiguous
        (U, V, acd[:2], rowptr),                          # acd shape
        (U, V, acd, torch.tensor([0, 1], dtype=torch.int32)),  # rowptr sum
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            spspmm_sum.spspmm_sum(*args)


def test_wrapper_has_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error, never
    the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spspmm_sum.spspmm_sum(
            torch.empty(4, 8, **meta), torch.empty(3, 8, **meta),
            torch.empty(3, 2, dtype=torch.int32, **meta),
            torch.empty(5, dtype=torch.int32, **meta))


def test_build_is_keyed_and_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["spspmm_sum"])
    # an already-built library (same source, same flags) is not rebuilt
    lib = _build.library_path("spspmm_sum")
    assert lib.parent == tmp_path and lib.name.startswith("libspspmm_sum-")
    lib.write_bytes(b"")
    assert _build.build(["spspmm_sum"]) == {"spspmm_sum": 0.0}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("spspmm_sum") != lib
