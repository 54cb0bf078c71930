"""The chunk schedule of K1 and K4 (``csrc/chunk_walk.cuh``), simulated on
the CPU.

The kernels give each warp a chunk of ``C`` triples and the rows that
start in it, find the chunk's rows on the card from the triples' own
output rows, and leave the empty rows to separate warps of 32 rows each.
The CUDA sources cannot run here, so these tests walk the same schedule
in Python, warp by warp, as the kernels do (``load_chunk``,
``stream_walk``, the forward's whole-row batches and ``zero_rows``), with
each role's ``C`` (``Role.CHUNK``) and ``F`` (the ``kInFlight`` constants
of the sources), and check that every output row is stored by exactly one
warp, that each row's triples are summed in their order, and that sums
taken in the walk's order equal ``contract_plain`` and
``attention_plain`` bit for bit.
"""

import re
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.hodata.loader import backward_orders, row_pointer
from pygho_tpu_torch.kernels import segment_attention as k4
from pygho_tpu_torch.kernels import spspmm_sum as k1

CSRC = Path(k1.__file__).resolve().parent.parent / "csrc"
KEY = "X___X___1___A___0"
ZERO_ROWS = 32      # chunk_walk::kZeroRows
MASK = 0xFFFFFFFF   # a 32-bit lane mask


def in_flight(source, names):
    """The ``kInFlight<name>`` constants of a CUDA source."""
    text = (CSRC / source).read_text()
    return [int(re.search(rf"constexpr int kInFlight{n} = (\d+);",
                          text).group(1)) for n in names]


K1_F = dict.fromkeys(k1.ROLES, *in_flight("spspmm_sum.cu", ("",)))
K4_F = dict(zip(k4.ROLES, in_flight("segment_attention.cu",
                                    ("Fwd", "DW", "DC", "DV"))))


def low_bit(m):
    return (m & -m).bit_length() - 1


def load_chunk(w, C, t, rowptr):
    """``chunk_walk::load_chunk`` for warp ``w``: None where no row starts
    in the chunk, else the chunk's first triple, first row start, end, row
    starts (bit j: triple c0 + j) and the 32 lanes' output rows."""
    k = t.shape[0]
    c0 = w * C
    pos = c0 + np.arange(32)
    inn = pos < k
    lane_t = np.where(inn, t[np.minimum(pos, max(k - 1, 0))], -1)
    prev = np.r_[t[c0 - 1] if c0 > 0 else -1, lane_t[:-1]]
    starts = 0
    for j in range(32):
        if j < C and inn[j] and lane_t[j] != prev[j]:
            starts |= 1 << j
    if not starts:
        return None
    t_last = lane_t[starts.bit_length() - 1]
    same = np.flatnonzero(inn & (lane_t == t_last))
    top = int(same.max())
    end = c0 + top + 1 if top < 31 else int(rowptr[t_last + 1])
    return dict(c0=c0, first=c0 + low_bit(starts), end=end, starts=starts,
                t=lane_t)


def stream_walk(ch, F):
    """``chunk_walk::stream_walk``'s stores: [(row, its triples in the
    order they are added)], and the sizes of the groups of gathers."""
    wb, starts, p = ch["c0"], ch["starts"], ch["first"]
    row, cur, stores, groups = -1, [], [], []
    while p < ch["end"]:
        if p == wb + 32:
            wb, starts = p, 0
        rel = p - wb
        n = min(F, ch["end"] - p, 32 - rel)
        groups.append(n)
        for q in range(n):
            if (starts >> (rel + q)) & 1:
                if row >= 0:
                    stores.append((row, cur))
                row, cur = int(ch["t"][rel + q]), []
            cur.append(p + q)
        p += n
    stores.append((row, cur))
    return stores, groups


def forward_walk(ch, F, t):
    """The forward's walk (``forward_walk`` in segment_attention.cu): its
    stores [(row, triples)] and, for each, whether it went in a batch of
    whole rows (with the batch's triple count) or alone as a long row."""
    wb, starts, pos, end = ch["c0"], ch["starts"], ch["first"], ch["end"]
    lane_t = ch["t"]
    stores = []
    while pos < end:
        if pos + min(F, end - pos) > wb + 32:
            shift = pos - wb
            starts = starts >> shift if shift < 32 else 0
            wb = pos
            q = wb + np.arange(32)
            lane_t = np.where(q < end, t[np.minimum(q, t.shape[0] - 1)], -1)
        rel = pos - wb
        after = starts & ~((2 << rel) - 1) & MASK
        row_end = wb + low_bit(after) if after else end
        if row_end - pos > F:
            stores.append((int(lane_t[rel]), list(range(pos, row_end)),
                           "long"))
            pos = row_end
            continue
        stop = end
        if end - pos > F:
            lim = rel + F
            m = after if lim >= 31 else after & ((2 << lim) - 1)
            stop = wb + m.bit_length() - 1
        nb = stop - pos
        rs = ((starts >> rel) & ((1 << nb) - 1)) | 1
        bounds = [q for q in range(nb) if (rs >> q) & 1] + [nb]
        for a, b in zip(bounds[:-1], bounds[1:]):
            stores.append((int(lane_t[rel + a]),
                           list(range(pos + a, pos + b)), nb))
        pos = stop
    return stores


def schedule(t, out_rows, C, walk):
    """Every warp's stores over ``out_rows`` rows: the chunk warps' (by
    ``walk``), then the zeroing warps'.  Returns ({row: (warp, triples,
    how)}, chunk warps); fails where a row is stored twice."""
    rowptr = row_pointer(t, out_rows)
    k = t.shape[0]
    n_chunks = -(-k // C)
    owner = {}

    def put(row, w, tri, how):
        assert row not in owner, f"row {row} stored twice"
        owner[row] = (w, tri, how)

    for w in range(n_chunks):
        ch = load_chunk(w, C, t, rowptr)
        if ch is None:
            continue
        for store in walk(ch):
            put(store[0], w, store[1], store[2] if len(store) > 2 else None)
    for zw in range(-(-out_rows // ZERO_ROWS)):
        for r in range(zw * ZERO_ROWS, min(out_rows, (zw + 1) * ZERO_ROWS)):
            if rowptr[r] == rowptr[r + 1]:
                put(r, n_chunks + zw, [], "zero")
    return owner, n_chunks


def check_owners(owner, t, out_rows, C):
    """Each row stored once; a row with triples by the warp whose chunk
    holds its first triple, with exactly its triples in order; an empty
    row by the zeroing warp of its 32 rows."""
    rowptr = row_pointer(t, out_rows)
    n_chunks = -(-t.shape[0] // C)
    assert sorted(owner) == list(range(out_rows))
    for r, (w, tri, how) in owner.items():
        lo, hi = int(rowptr[r]), int(rowptr[r + 1])
        if lo == hi:
            assert how == "zero" and w == n_chunks + r // ZERO_ROWS
        else:
            assert w == lo // C, (r, w, lo)
            assert tri == list(range(lo, hi)), r


def main_batch():
    """The main path's first 128-graph training batch, as chip_smoke.py
    builds it: (acd, tuple rows, edge rows)."""
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in synthetic_zinc("val", seed=42)]
    batch = next(iter(SpDataloader(datas, 128, [KEY], backward=True)))
    return (batch[f"{KEY}___acd"].astype(np.int64),
            batch["tupleid"].shape[1], batch["edge_index"].shape[1])


def edge_acd(rng, case, C=16):
    """The edge workloads: (acd sorted by a, x_rows, e_rows)."""
    x_rows, e_rows = 400, 300
    if case == "no triples":
        return np.zeros((3, 0), np.int64), 70, 10
    if case == "all rows empty":
        return np.zeros((3, 0), np.int64), 1000, 10
    lens = rng.integers(0, 6, x_rows)
    lens[[3, 150]] = 0
    if case == "long row":             # over several chunks and windows
        lens[7], lens[8], lens[9] = 120, 33, 32
    elif case == "empty run":          # 130 empty rows mid-array
        lens[200:330] = 0
    elif case == "padded tail":        # the last 60 rows empty
        lens[-60:] = 0
    elif case == "forward thresholds":  # rows of 4, 5, 8, 9 and 31 triples
        lens[40:45] = (4, 5, 8, 9, 31)
    elif case == "k not a multiple of C":
        lens[-1] += (5 - lens.sum()) % C
    a = np.repeat(np.arange(x_rows), lens)
    acd = np.stack([a, rng.integers(0, x_rows, a.size),
                    rng.integers(0, e_rows, a.size)])
    if case == "k not a multiple of C":
        assert acd.shape[1] % C == 5
    return acd, x_rows, e_rows


EDGE_CASES = ["no triples", "all rows empty", "long row", "empty run",
              "padded tail", "forward thresholds", "k not a multiple of C"]


def orders(acd, x_rows, e_rows):
    """Each role's triples and output rows: forward, dX (dc) and dA (dv)
    orders, as the loader builds them."""
    o = backward_orders(acd, x_rows, e_rows)
    return {"fwd": (acd, x_rows), "dx": (o["dx"][0].astype(np.int64),
                                         x_rows),
            "da": (o["da"][0].astype(np.int64), e_rows)}


@pytest.fixture(scope="module")
def main():
    return main_batch()


@pytest.mark.parametrize("case", ["main"] + EDGE_CASES)
@pytest.mark.parametrize("role", k1.ROLES, ids=lambda r: r.NAME)
def test_k1_chunks_write_every_row_once(role, case, main):
    """K1's schedule, with its role's C and F: every row stored by one
    warp, its triples in order, the empty ones by the zeroing warps."""
    acd, x_rows, e_rows = main if case == "main" else \
        edge_acd(np.random.default_rng(0), case)
    order = {k1.FWD: "fwd", k1.DX: "dx", k1.DA: "da"}[role]
    tuv, out_rows = orders(acd, x_rows, e_rows)[order]
    t = tuv[0]
    owner, _ = schedule(t, out_rows, role.CHUNK,
                        lambda ch: stream_walk(ch, K1_F[role])[0])
    check_owners(owner, t, out_rows, role.CHUNK)
    if case == "empty run" and role is k1.FWD:
        # the forward's 130 empty rows spread over several zeroing warps
        assert len({owner[r][0] for r in range(200, 330)}) >= 4


@pytest.mark.parametrize("case", ["main"] + EDGE_CASES)
@pytest.mark.parametrize("role", k4.ROLES, ids=lambda r: r.NAME)
def test_k4_chunks_write_every_row_once(role, case, main):
    """K4's schedule: the gradient roles' as K1's, the forward's whole-row
    batches of at most F triples and its long rows alone."""
    acd, x_rows, e_rows = main if case == "main" else \
        edge_acd(np.random.default_rng(0), case)
    order = {k4.FWD: "fwd", k4.DW: "fwd", k4.DC: "dx", k4.DV: "da"}[role]
    tuv, out_rows = orders(acd, x_rows, e_rows)[order]
    t, F = tuv[0], K4_F[role]
    walk = (lambda ch: forward_walk(ch, F, t)) if role is k4.FWD \
        else (lambda ch: stream_walk(ch, F)[0])
    owner, _ = schedule(t, out_rows, role.CHUNK, walk)
    check_owners(owner, t, out_rows, role.CHUNK)
    if role is k4.FWD:
        # a row of more than F triples goes alone, twice over its triples;
        # the others in batches of whole rows, at most F triples a batch
        for r, (_, tri, how) in owner.items():
            if how != "zero":
                assert (how == "long") == (len(tri) > F), r
                assert how == "long" or len(tri) <= how <= F


def test_chunk_rule_on_the_main_batch(main):
    """The main batch's orders hold what the schedule was sized for: about
    two triples a row in the forward and dX orders, eleven in dA; at C =
    16 about 3,800 chunk warps and 1,024 zeroing warps in the forward."""
    acd, x_rows, e_rows = main
    assert acd.shape[1] == 60224 and (x_rows, e_rows) == (32768, 6144)
    for name, (tuv, rows) in orders(acd, x_rows, e_rows).items():
        t = tuv[0]
        per_row = np.bincount(t, minlength=rows)
        assert per_row.max() <= 32 if name != "da" else per_row.max() < 64
    t = acd[0]
    owner, n_chunks = schedule(t, x_rows, 16,
                               lambda ch: stream_walk(ch, 8)[0])
    assert n_chunks == 3764
    zero = [r for r, (_, _, how) in owner.items() if how == "zero"]
    assert len(zero) == int((np.bincount(t, minlength=x_rows) == 0).sum())


def walk_sum(owner, terms, rows, D):
    """Each row's sum of ``terms`` (numpy f32, one row a triple) in the
    walk's order, from 0, a rounded add a term; empty rows 0."""
    out = np.zeros((rows, D), np.float32)
    for r, (_, tri, _) in owner.items():
        acc = np.zeros(D, np.float32)
        for p in tri:
            acc = acc + terms[p]
        out[r] = acc
    return out


@pytest.mark.parametrize("case", ["main", "long row", "empty run",
                                  "k not a multiple of C"])
@pytest.mark.parametrize("role", k1.ROLES, ids=lambda r: r.NAME)
def test_k1_walk_order_sums_equal_plain_bitwise(role, case, main):
    """Products rounded, then added in the walk's order, per row: the
    same bits as ``contract_plain``."""
    rng = np.random.default_rng(1)
    acd, x_rows, e_rows = main if case == "main" else edge_acd(rng, case)
    order = {k1.FWD: "fwd", k1.DX: "dx", k1.DA: "da"}[role]
    tuv, out_rows = orders(acd, x_rows, e_rows)[order]
    u_rows = {k1.FWD: x_rows, k1.DX: x_rows, k1.DA: x_rows}[role]
    v_rows = {k1.FWD: e_rows, k1.DX: e_rows, k1.DA: x_rows}[role]
    D = 16
    U = rng.normal(size=(u_rows, D)).astype(np.float32)
    V = rng.normal(size=(v_rows, D)).astype(np.float32)
    owner, _ = schedule(tuv[0], out_rows, role.CHUNK,
                        lambda ch: stream_walk(ch, K1_F[role])[0])
    got = walk_sum(owner, U[tuv[1]] * V[tuv[2]], out_rows, D)
    ref = k1.contract_plain(torch.from_numpy(U), torch.from_numpy(V),
                            torch.from_numpy(tuv), out_rows).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["main", "long row", "forward thresholds",
                                  "k not a multiple of C"])
@pytest.mark.parametrize("role", k4.ROLES, ids=lambda r: r.NAME)
def test_k4_walk_order_sums_equal_plain_bitwise(role, case, main):
    """K4's sums in the walk's order, each term formed as the kernel forms
    it (the forward's maximum a fold of fmax in the walk's order): the
    same bits as ``attention_plain``."""
    rng = np.random.default_rng(2)
    acd, x_rows, e_rows = main if case == "main" else edge_acd(rng, case)
    D = 16
    ops = [torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
           for n in (x_rows, x_rows, e_rows, x_rows)]
    a1, a3, aA, a2 = ops
    fwd_tuv = torch.from_numpy(acd)
    out, den, M = k4.attention_plain(k4.FWD, *ops, fwd_tuv, x_rows)
    gZ, goZ = k4.softmax_cotangents(
        torch.from_numpy(rng.normal(size=(x_rows, D)).astype(np.float32)),
        out, den)
    order = {k4.FWD: "fwd", k4.DW: "fwd", k4.DC: "dx", k4.DV: "da"}[role]
    tuv, out_rows = orders(acd, x_rows, e_rows)[order]
    t, F = tuv[0], K4_F[role]
    walk = (lambda ch: forward_walk(ch, F, t)) if role is k4.FWD \
        else (lambda ch: stream_walk(ch, F)[0])
    owner, _ = schedule(t, out_rows, role.CHUNK, walk)
    idx = torch.from_numpy(tuv)
    a, c, d = (idx[i] for i in k4.ACD_POSITIONS[role])
    s = (a1[c] * aA[d]) * a2[a]
    if role is k4.FWD:
        ref = attention = k4.attention_plain(role, *ops, idx, out_rows)
        m = np.zeros((out_rows, D), np.float32)
        for r, (_, tri, how) in owner.items():
            if tri:
                m[r] = np.maximum.reduce(s.numpy()[tri])
        np.testing.assert_array_equal(m, attention[2].numpy())
        e = torch.exp(s - attention[2][idx[0]])
        num = walk_sum(owner, (e * a3[c]).numpy(), out_rows, D)
        dsum = walk_sum(owner, e.numpy(), out_rows, D)
        got = (num / np.where(dsum > 0, dsum, 1), dsum, m)
    else:
        e = torch.exp(s - M[a])
        ds = e * (a3[c] * gZ[a] - goZ[a])
        if role is k4.DW:
            terms = [(ds * a1[c]) * aA[d]]
        elif role is k4.DC:
            terms = [(ds * aA[d]) * a2[a], e * gZ[a]]
        else:
            terms = [(ds * a1[c]) * a2[a]]
        got = [walk_sum(owner, x.numpy(), out_rows, D) for x in terms]
        ref = k4.attention_plain(role, *ops, idx, out_rows, M, gZ, goZ)
    for x, r in zip(got, ref):
        np.testing.assert_array_equal(x, r.numpy())


def test_walk_keeps_F_triples_in_flight():
    """In a chunk of 32 one-triple rows, stream_walk issues groups of F;
    past the 32 triples in the lanes a long row goes on in groups of F
    (fewer only at a window's end or the row's)."""
    t = np.arange(32)
    ch = load_chunk(0, 32, t, row_pointer(t, 32))
    assert stream_walk(ch, 8)[1] == [8, 8, 8, 8]
    t = np.zeros(100, np.int64)
    ch = load_chunk(0, 32, t, row_pointer(t, 1))
    assert ch["end"] == 100
    assert stream_walk(ch, 8)[1] == [8] * 12 + [4]
    stores, groups = stream_walk(ch, 16)
    assert groups == [16, 16] * 3 + [4] and stores[0][1] == list(range(100))
