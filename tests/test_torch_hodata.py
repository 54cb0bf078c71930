"""The port's host layer against the JAX package's: the same graphs from
the same seed, and identical arrays out of the sampler, the per-graph
precompute (acd triples included) and the batch collation.  Exact
equality: both sides are the same numpy code."""

import numpy as np
import pytest

from pygho_tpu.backend import indexing as jx_indexing
from pygho_tpu.hodata import datasets as jx_datasets
from pygho_tpu.hodata import sp_data as jx_sp_data
from pygho_tpu.hodata.loader import Sppretransform as JxSppretransform
from pygho_tpu.hodata.sp_sampler import KhopSampler as JxKhopSampler

from pygho_tpu_torch.backend import indexing as pt_indexing
from pygho_tpu_torch.hodata import datasets as pt_datasets
from pygho_tpu_torch.hodata import sp_data as pt_sp_data
from pygho_tpu_torch.hodata.loader import (Buckets, SpDataloader,
                                           Sppretransform, add_rowptr)
from pygho_tpu_torch.hodata.sp_sampler import KhopSampler

KEY = "X___X___1___A___0"


def _same(a, b):
    """Identical keys, dtypes, shapes and values, recursively."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_synthetic_zinc_same_graphs():
    for split in ("train", "val"):
        jx = jx_datasets.synthetic_zinc(split, n_graphs=24)
        pt = pt_datasets.synthetic_zinc(split, n_graphs=24)
        for gj, gp in zip(jx, pt):
            for f in ("x", "edge_index", "edge_attr", "y"):
                _same(getattr(gj, f), getattr(gp, f))
            assert gj.num_nodes == gp.num_nodes


@pytest.mark.parametrize("hop", [1, 2, 3])
def test_khop_sampler_identical(hop):
    for gj, gp in zip(jx_datasets.synthetic_zinc("val", n_graphs=10),
                      pt_datasets.synthetic_zinc("val", n_graphs=10)):
        _same(JxKhopSampler(gj, hop=hop), KhopSampler(gp, hop=hop))


def test_spspmm_ind_numpy_join_identical(rng):
    """The port keeps only the numpy join of spspmm_ind; it must give the
    JAX package's triples whichever join that package picked."""
    for _ in range(5):
        n = int(rng.integers(5, 30))
        keep = rng.random((n, n)) < 0.3
        ind1 = np.stack(np.nonzero(keep)).astype(np.int64)
        ind2 = np.stack(np.nonzero(rng.random((n, n)) < 0.3))
        for d1, d2 in ((1, 0), (0, 1), (1, 1)):
            tj, bj = jx_indexing.spspmm_ind(ind1, d1, ind2, d2)
            tp, bp = pt_indexing.spspmm_ind(ind1, d1, ind2, d2)
            _same(tj, tp)
            _same(bj, bp)
            _same(jx_indexing.filterind(ind1, tj, bj),
                  pt_indexing.filterind(ind1, tp, bp))


@pytest.mark.parametrize("hop", [2, 3])
def test_preprocess_and_collate_identical(hop):
    from functools import partial

    graphs_j = jx_datasets.synthetic_zinc("val", n_graphs=12)
    graphs_p = pt_datasets.synthetic_zinc("val", n_graphs=12)
    pre_j = JxSppretransform(partial(JxKhopSampler, hop=hop), [""], [KEY])
    pre_p = Sppretransform(partial(KhopSampler, hop=hop), [""], [KEY])
    datas_j = [pre_j(g) for g in graphs_j]
    datas_p = [pre_p(g) for g in graphs_p]
    for dj, dp in zip(datas_j, datas_p):
        _same(dj, dp)
    # two batches through shared buckets, the second padded to 8 graphs
    bj, bp = {}, Buckets()
    for sl in (slice(0, 8), slice(8, 12)):
        cj = jx_sp_data.collate_sparse(datas_j[sl], [KEY], [""], 8, bj)
        cp = pt_sp_data.collate_sparse(datas_p[sl], [KEY], [""], 8, bp)
        _same(cj, cp)
    assert dict(bj) == dict(bp)


def test_add_rowptr_strips_padding_and_indexes_rows():
    pre = Sppretransform(partial_khop(3), [""], [KEY])
    datas = [pre(g) for g in pt_datasets.synthetic_zinc("val", n_graphs=6)]
    batch = pt_sp_data.collate_sparse(datas, [KEY], [""], 8)
    padded = batch[f"{KEY}___acd"].copy()
    add_rowptr(batch, [KEY])
    acd, rowptr = batch[f"{KEY}___acd"], batch[f"{KEY}___rowptr"]
    real = padded[0] < pt_indexing.PAD_INDEX
    assert acd.dtype == np.int32 and rowptr.dtype == np.int32
    np.testing.assert_array_equal(acd, padded[:, real])
    assert rowptr.shape == (batch["tupleid"].shape[1] + 1,)
    assert rowptr[0] == 0 and rowptr[-1] == acd.shape[1]
    for r in range(0, rowptr.shape[0] - 1, 37):
        assert np.all(acd[0, rowptr[r]:rowptr[r + 1]] == r)
    # padded tuple rows get no triples
    nt = int(batch["num_tuples"])
    assert np.all(rowptr[nt:] == acd.shape[1])


def test_add_rowptr_rejects_unsorted_and_out_of_range():
    pre = Sppretransform(partial_khop(2), [""], [KEY])
    datas = [pre(g) for g in pt_datasets.synthetic_zinc("val", n_graphs=3)]
    batch = pt_sp_data.collate_sparse(datas, [KEY], [""], 4)
    bad = dict(batch)
    acd = bad[f"{KEY}___acd"].copy()
    acd[0, [0, 1]] = acd[0, [1, 0]] + np.array([5, 0])
    bad[f"{KEY}___acd"] = acd
    with pytest.raises(ValueError, match="sorted"):
        add_rowptr(bad, [KEY])
    bad = dict(batch)
    acd = bad[f"{KEY}___acd"].copy()
    acd[2, 0] = batch["edge_index"].shape[1]
    bad[f"{KEY}___acd"] = acd
    with pytest.raises(ValueError, match="out of range"):
        add_rowptr(bad, [KEY])


def test_dataloader_order_and_buckets():
    pre = Sppretransform(partial_khop(2), [""], [KEY])
    datas = [pre(g) for g in pt_datasets.synthetic_zinc("val", n_graphs=10)]
    dl = SpDataloader(datas, 4, [KEY])
    batches = list(dl)
    assert len(dl) == len(batches) == 3
    assert [int(b["num_graphs_real"]) for b in batches] == [4, 4, 2]
    assert all(b["graph_mask"].shape == (4,) for b in batches)
    # buckets only grow, and the last batch reuses the largest shape
    assert batches[-1]["tupleid"].shape[1] == dl.buckets["tuples"]
    y = np.concatenate([b["y"][b["graph_mask"]] for b in batches])
    np.testing.assert_array_equal(y, np.stack([d["y"] for d in datas]))


def partial_khop(hop):
    from functools import partial

    return partial(KhopSampler, hop=hop)
