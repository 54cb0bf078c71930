"""The giant-graph slice of the port against the JAX package, on the CPU:
K3's chunk plans (``kernels/window_spspmm.py``) and a simulation of the
kernel's schedule, K3's contraction and gradients against
``fused_spspmm_strip`` on persistent-V-window (pv) plans, which runs the
TPU kernel ``_strip_kernel_pv`` in interpret mode, ``rcm_reorder`` and the
hop-1 triples, and the giant-graph training step against JAX's
``make_giant_graph_step`` on a one-device mesh.

Every input comes from a numpy seed; each test states its tolerance."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.backend import indexing as jx_indexing
from pygho_tpu.hodata.graph import Graph as JxGraph
from pygho_tpu.hodata.graph import rcm_reorder as jx_rcm_reorder
from pygho_tpu.kernels import strip_spspmm as jx_strip
from pygho_tpu.parallel import build_giant_graph_plan as jx_build_plan
from pygho_tpu.parallel import init_giant_params as jx_init_params
from pygho_tpu.parallel import make_giant_graph_step as jx_make_step
from pygho_tpu.parallel import make_mesh

from pygho_tpu_torch.backend import indexing
from pygho_tpu_torch.hodata.graph import Graph, rcm_reorder
from pygho_tpu_torch.hodata.loader import backward_orders, row_pointer
from pygho_tpu_torch.kernels import window_spspmm as k3
from pygho_tpu_torch.kernels.spspmm_sum import contract_plain
from pygho_tpu_torch.parallel import (build_giant_graph_plan,
                                      init_giant_params,
                                      make_giant_graph_step)
from pygho_tpu_torch.weights import flatten_params, load_jax_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "example"))
from giant_graph_gpu import community_graph, giant_instance  # noqa: E402

# K3 and its gradients against the JAX pv kernel in interpret mode: the
# same f32 products of values of order 1, summed in another order (the
# TPU kernel sums one-hot matrix products); rows sum 2 to 4 products, as
# tests/test_kernels.py's pv test holds its kernel to its oracle
K3_TOL = 1e-4
# the giant step against JAX's: f32 without TF32 on both, through three
# layers, the root pooling and the readout, summed in other orders; the
# loss is of order 0.1 and the parameters of order 0.3
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6


def hop1(idx, edge_index, n):
    """Hop-1 tuples and contraction triples, with ``idx`` the indexing
    module of either package (``example/giant_graph_tpu.py`` step 2)."""
    ii = np.concatenate([np.arange(n), edge_index[0]])
    jj = np.concatenate([np.arange(n), edge_index[1]])
    tup, _ = idx.coalesce(np.stack([ii, jj]))
    tar, bcd = idx.spspmm_ind(tup, 1, edge_index, 0)
    return tup, idx.filterind(tup, tar, bcd)


def community_triples(rng, n_com=8, tup_per=512, edg_per=256, K=8192):
    """The community workload of tests/test_kernels.py's pv test: triples
    inside their community, ``t`` sorted, ``u`` near ``t``, ``v`` anywhere
    in the community's edge block."""
    com = np.sort(rng.integers(0, n_com, K))
    t = np.sort(com * tup_per + rng.integers(0, tup_per, K))
    com_t = t // tup_per
    u = com_t * tup_per + rng.integers(0, tup_per, K)
    v = com_t * edg_per + rng.integers(0, edg_per, K)
    return np.stack([t, u, v]).astype(np.int64), n_com * tup_per, \
        n_com * edg_per


def run_schedule(p, U, V):
    """The kernel's schedule in numpy f32: each warp walks its rows in
    order over its triples, each product rounded, then added to the row's
    sum, which is stored when the row ends (a row with no triples stores
    0).  Checks on the way that each row is stored once, by its owner."""
    out = np.full((p.out_rows, U.shape[1]), np.nan, np.float32)
    u, v = p.tuv[1], p.tuv[2]
    for w in range(p.n_warps):
        r0, r1 = p.warp_row[w], p.warp_row[w + 1]
        assert 1 <= r1 - r0 <= k3.CHUNK_ROWS
        ri, acc = r0, np.zeros(U.shape[1], np.float32)
        for t in range(p.rowptr[r0], p.rowptr[r1]):
            while t >= p.rowptr[ri + 1]:
                assert np.isnan(out[ri]).all(), ri
                out[ri], acc = acc, np.zeros(U.shape[1], np.float32)
                ri += 1
            acc = acc + U[u[t]] * V[v[t]]
        for r in range(ri, r1):
            assert np.isnan(out[r]).all(), r
            out[r], acc = acc, np.zeros(U.shape[1], np.float32)
    assert not np.isnan(out).any(), "a row was never written"
    return out


def edge_triples(rng, out_rows=300, u_rows=400, v_rows=2000):
    """Short rows (0 to 5 triples) with empty rows among them, a run of 61
    empty rows, a 120-triple row over five chunks, a row whose first triple
    starts a chunk, and a tail of empty rows: ``(tuv, out_rows, u_rows,
    v_rows, the row at a chunk start)``."""
    lens = rng.integers(0, 6, out_rows)
    lens[[3, 150]] = 0
    lens[200:261] = 0
    lens[7] = 120
    lens[-20:] = 0
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    r = 20 + int(np.argmax((starts[20:] % k3.CHUNK_TRIPLES != 0)
                           & (lens[20:] > 0)))
    lens[r - 1] += k3.CHUNK_TRIPLES - starts[r] % k3.CHUNK_TRIPLES
    t = np.repeat(np.arange(out_rows), lens)
    tuv = np.stack([t, rng.integers(0, u_rows, t.size),
                    rng.integers(0, v_rows, t.size)])
    return tuv, out_rows, u_rows, v_rows, r


def check_chunks(p):
    """Each output row owned by exactly one warp: the warps' rows tile
    ``[0, out_rows)`` in order, 1 to CHUNK_ROWS rows each; the rows of a
    warp start in one chunk of CHUNK_TRIPLES triples, and a warp starts a
    new chunk or continues a run of CHUNK_ROWS rows of the one before."""
    wr, rp = p.warp_row.astype(np.int64), p.rowptr.astype(np.int64)
    assert wr[0] == 0 and wr[-1] == p.out_rows
    size = np.diff(wr)
    assert size.min(initial=1) >= 1 and size.max(initial=1) <= k3.CHUNK_ROWS
    chunk = rp[:-1] // k3.CHUNK_TRIPLES
    owner = np.repeat(np.arange(p.n_warps), size)
    for w in range(p.n_warps):
        assert np.all(chunk[wr[w]:wr[w + 1]] == chunk[wr[w]])
        if w:
            assert chunk[wr[w]] > chunk[wr[w - 1]] \
                or size[w - 1] == k3.CHUNK_ROWS
    return owner


def test_chunk_plan_invariants():
    """The chunk plan on the edge workload: every row, empty ones too, is
    owned by one warp; the run of 61 empty rows spans two warps and more;
    the 120-triple row's warp runs past its chunk, and the warp after it
    starts where the row ends; the row at a chunk start opens a warp."""
    rng = np.random.default_rng(0)
    tuv, out_rows, u_rows, v_rows, r = edge_triples(rng)
    p = k3.build_chunk_plan(tuv, out_rows, u_rows, v_rows)
    owner = check_chunks(p)
    np.testing.assert_array_equal(p.tuv, tuv)
    np.testing.assert_array_equal(p.rowptr, row_pointer(tuv[0], out_rows))
    assert len(set(owner[200:261])) >= 2
    w7 = owner[7]
    assert p.rowptr[p.warp_row[w7 + 1]] - p.rowptr[p.warp_row[w7]] >= 120
    assert p.rowptr[p.warp_row[w7 + 1]] == p.rowptr[8]
    assert r in set(p.warp_row) and p.rowptr[r] % k3.CHUNK_TRIPLES == 0
    # no triples: the rows still split into warps that store zeros
    empty = k3.build_chunk_plan(np.zeros((3, 0), np.int64), 70, 4, 5)
    check_chunks(empty)
    assert empty.n_warps == 3
    assert k3.build_chunk_plan(np.zeros((3, 0)), 0, 1, 1).n_warps == 0


@pytest.mark.parametrize("case", ["edge_D128", "edge_D13", "dense_rows",
                                  "one_long_row", "no_triples"])
def test_chunk_schedule_simulation_matches_plain_bitwise(case):
    """The kernel's schedule, simulated in numpy f32 (each product
    rounded, then added, in the warp's order), equals ``contract_plain``
    bit for bit: the triples keep their order, so the sums are the same
    sums."""
    rng = np.random.default_rng(1)
    D = 13 if case == "edge_D13" else 128
    if case.startswith("edge"):
        tuv, out_rows, u_rows, v_rows, _ = edge_triples(rng)
    elif case == "dense_rows":       # 40 triples a row: every row spans
        t = np.repeat(np.arange(50), 40)
        out_rows, u_rows, v_rows = 50, 60, 70
        tuv = np.stack([t, rng.integers(0, u_rows, t.size),
                        rng.integers(0, v_rows, t.size)])
    elif case == "one_long_row":     # one warp, 1,000 triples
        out_rows, u_rows, v_rows = 1, 30, 30
        tuv = np.stack([np.zeros(1000, np.int64),
                        rng.integers(0, u_rows, 1000),
                        rng.integers(0, v_rows, 1000)])
    else:
        out_rows, u_rows, v_rows = 45, 4, 5
        tuv = np.zeros((3, 0), np.int64)
    p = k3.build_chunk_plan(tuv, out_rows, u_rows, v_rows)
    check_chunks(p)
    U = rng.normal(size=(u_rows, D)).astype(np.float32)
    V = rng.normal(size=(v_rows, D)).astype(np.float32)
    ref = contract_plain(torch.from_numpy(U), torch.from_numpy(V),
                         torch.from_numpy(tuv), out_rows).numpy()
    np.testing.assert_array_equal(run_schedule(p, U, V), ref)


def test_chunk_plans_on_the_giant_graph_are_k1_orders():
    """On an 8x30 community graph (RCM, hop-1 tuples), the three roles'
    plans are exactly K1's: ``acd`` and the orders of ``backward_orders``,
    each with ``row_pointer``, plus their warp chunks."""
    rng = np.random.default_rng(0)
    n = 8 * 30
    g = rcm_reorder(Graph(x=np.zeros((n, 1)), edge_index=community_graph(
        rng, 8, 30), edge_attr=None).coalesced())
    tup, acd = hop1(indexing, g.edge_index, n)
    nnz, ne = tup.shape[1] + 7, g.num_edges     # 7 padded tuple rows
    plans = k3.build_chunk_plans(acd, nnz, ne, nnz)
    orders = backward_orders(acd, nnz, ne)
    want = ((acd, row_pointer(acd[0], nnz)), orders["dx"], orders["da"])
    for p, (tuv, rowptr), rows in zip(plans, want, (nnz, nnz, ne)):
        np.testing.assert_array_equal(p.tuv, tuv)
        np.testing.assert_array_equal(p.rowptr, rowptr)
        np.testing.assert_array_equal(p.warp_row,
                                      k3.warp_chunks(rowptr))
        assert p.out_rows == rows and p.tuv.dtype == np.int32
        check_chunks(p)
    assert (plans[0].u_rows, plans[0].v_rows) == (nnz, ne)
    assert (plans[1].u_rows, plans[1].v_rows) == (nnz, ne)
    assert (plans[2].u_rows, plans[2].v_rows) == (nnz, nnz)


def test_chunk_plan_refuses_bad_triples():
    with pytest.raises(ValueError, match="not sorted"):
        k3.build_chunk_plan(np.array([[1, 0], [0, 0], [0, 0]]), 2, 1, 1)
    with pytest.raises(ValueError, match="t out of range"):
        k3.build_chunk_plan(np.array([[2], [0], [0]]), 2, 1, 1)
    with pytest.raises(ValueError, match="u out of range"):
        k3.build_chunk_plan(np.array([[0], [-1], [0]]), 2, 1, 1)
    with pytest.raises(ValueError, match="v out of range"):
        k3.build_chunk_plan(np.array([[0], [0], [5]]), 2, 1, 1)
    with pytest.raises(ValueError, match=r"\(3, k\)"):
        k3.build_chunk_plan(np.zeros((2, 4), np.int64), 2, 1, 1)


def _pv_case():
    """The pv test's workload and geometry (tests/test_kernels.py:932):
    8 communities, K = 8192, D = 128, Rv covering two communities."""
    rng = np.random.default_rng(0)
    acd, n_out, n_v = community_triples(rng)
    D = 128
    U = rng.normal(size=(n_out, D)).astype(np.float32)
    V = rng.normal(size=(n_v, D)).astype(np.float32)
    W = rng.normal(size=(n_out, D)).astype(np.float32)
    return acd, n_out, n_v, U, V, W


def test_k3_matches_jax_pv_kernel_forward_and_gradients():
    """K3's forward, and ``WindowSpspmmSum``'s dX and dA roles, against
    ``fused_spspmm_strip`` on pv plans (``_strip_kernel_pv`` in interpret
    mode), within K3_TOL."""
    acd, n_out, n_v, U, V, W = _pv_case()
    gpv = (256, 512, 128, 128, 512, 1, 16, 1)
    ppv = jx_strip.build_spspmm_strip_plans(acd, n_out, n_v, n_out,
                                            {"fwd": gpv, "dx": gpv,
                                             "da": gpv})
    assert ppv[0].v_persistent

    def jx_loss(a, b):
        out = jx_strip.fused_spspmm_strip(a, b, *ppv, True)[:n_out]
        return (out * jnp.asarray(W)).sum(), out

    (_, jx_out), (jx_gu, jx_gv) = jax.value_and_grad(
        jx_loss, (0, 1), has_aux=True)(jnp.asarray(U), jnp.asarray(V))

    plans = tuple(p.to("cpu") for p in k3.build_chunk_plans(
        acd, n_out, n_v, n_out))
    Ut = torch.from_numpy(U).requires_grad_()
    Vt = torch.from_numpy(V).requires_grad_()
    out = k3.WindowSpspmmSum.apply(Ut, Vt, plans)
    (out * torch.from_numpy(W)).sum().backward()
    for got, want in ((out.detach(), jx_out), (Ut.grad, jx_gu),
                      (Vt.grad, jx_gv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=K3_TOL, rtol=0)


@pytest.mark.parametrize("role", ["fwd", "dx", "da"])
def test_k3_roles_run_their_plans(role, monkeypatch):
    """``WindowSpspmmSum`` runs the forward role, then dX for the first
    operand's gradient and dA for the second's, each only where a gradient
    is asked for, on the matching plan."""
    acd, n_out, n_v, U, V, W = _pv_case()
    plans = tuple(p.to("cpu") for p in k3.build_chunk_plans(
        acd, n_out, n_v, n_out))
    calls = []
    real = k3.contract

    def spy(r, a, b, plan, *mode):
        calls.append((r.NAME, plan))
        return real(r, a, b, plan, *mode)

    monkeypatch.setattr(k3, "contract", spy)
    need = {"fwd": (False, False), "dx": (True, False), "da": (False, True)}
    gu, gv = need[role]
    Ut = torch.from_numpy(U).requires_grad_(gu)
    Vt = torch.from_numpy(V).requires_grad_(gv)
    out = k3.WindowSpspmmSum.apply(Ut, Vt, plans)
    if gu or gv:
        out.sum().backward()
    want = [(k3.FWD.NAME, plans[0])]
    if gu:
        want.append((k3.DX.NAME, plans[1]))
    if gv:
        want.append((k3.DA.NAME, plans[2]))
    assert [(n, id(p)) for n, p in calls] == [(n, id(p)) for n, p in want]


def test_k3_raw_wrapper_refuses():
    """The raw wrapper's checks: inputs that require grad, dtype, operands
    that do not match the plan, a plan not moved to the operands' device,
    and mismatched plans in the Function."""
    acd, n_out, n_v, U, V, _ = _pv_case()
    host = k3.build_chunk_plans(acd, n_out, n_v, n_out)
    plans = tuple(p.to("cpu") for p in host)
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    with pytest.raises(RuntimeError, match="WindowSpspmmSum"):
        k3.contract(k3.FWD, Ut.clone().requires_grad_(), Vt, plans[0])
    with pytest.raises(TypeError):
        k3.contract(k3.FWD, Ut.double(), Vt, plans[0])
    with pytest.raises(ValueError, match="plan is for"):
        k3.contract(k3.FWD, Ut[:-1], Vt, plans[0])
    with pytest.raises(ValueError, match="ChunkPlan.to"):
        k3.contract(k3.FWD, Ut, Vt, host[0])
    with pytest.raises(ValueError, match="do not match"):
        k3.WindowSpspmmSum.apply(Ut, Vt, (plans[0], plans[2], plans[1]))
    # the forward role on the CPU is the plain contraction
    torch.testing.assert_close(
        k3.contract(k3.FWD, Ut, Vt, plans[0]),
        contract_plain(Ut, Vt, torch.from_numpy(acd), n_out), rtol=0,
        atol=0)


def test_rcm_and_hop1_triples_match_jax():
    """``rcm_reorder`` (x permuted, the edge list relabelled and not
    re-sorted) and the hop-1 tuples and triples equal the JAX package's
    on an 8x30 community graph."""
    rng = np.random.default_rng(0)
    n = 8 * 30
    ei = community_graph(rng, 8, 30)
    x = np.arange(n)[:, None]
    mine = rcm_reorder(Graph(x=x, edge_index=ei, edge_attr=None).coalesced())
    ref = jx_rcm_reorder(JxGraph(x=x, edge_index=ei,
                                 edge_attr=None).coalesced())
    np.testing.assert_array_equal(mine.x, ref.x)
    np.testing.assert_array_equal(mine.edge_index, ref.edge_index)
    assert np.any(np.diff(mine.edge_index[0]) < 0), "edges were re-sorted"
    for got, want in zip(hop1(indexing, mine.edge_index, n),
                         hop1(jx_indexing, ref.edge_index, n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["overlapped", "ring",
                                      "reduce_scatter"])
def test_giant_step_matches_jax_one_device_mesh(strategy):
    """On a one-device CPU mesh, JAX's ``make_giant_graph_step`` (P = 1,
    each strategy) and the port's, with JAX's parameters carried across:
    the loss, three SGD steps' losses and the parameters after them agree
    within STEP_RTOL and PARAM_ATOL; ``n_real`` masks padded nodes."""
    L, d, lr = 3, 16, 0.05
    inp = giant_instance(8, 30, d)
    n, nnz_pad = inp["n"], inp["nnz_pad"]
    n_real = n - 10
    mesh = make_mesh((1,), ("sp",), devices=jax.devices()[:1])
    jplan = jx_build_plan(inp["acd_pad"], inp["tupleid"], nnz_pad, n, 1,
                          strategy=strategy)
    jparams = jx_init_params(L, d, seed=3)
    jloss_fn, jstep = jx_make_step(mesh, jplan, L, lr=lr, n_real=n_real)
    jXv, jAv, jy = (jnp.asarray(inp[k]) for k in ("Xv", "Av", "y"))

    plan = build_giant_graph_plan(inp["acd_pad"], inp["tupleid"], nnz_pad,
                                  n, 1, strategy=strategy,
                                  n_edge_rows=inp["Av"].shape[0],
                                  plan_dim=d)
    model = init_giant_params(L, d, device="cpu")
    load_jax_params(model, flatten_params(jax.tree.map(np.asarray,
                                                       jparams)))
    loss_fn, step = make_giant_graph_step(plan, L, lr=lr, n_real=n_real,
                                          device="cpu")
    Xv, Av, y = (torch.from_numpy(inp[k]) for k in ("Xv", "Av", "y"))

    with torch.no_grad():
        loss0 = float(loss_fn(model, Xv, Av, y))
    np.testing.assert_allclose(loss0, float(jloss_fn(jparams, jXv, jAv, jy)),
                               rtol=STEP_RTOL)
    for _ in range(3):
        jparams, jl = jstep(jparams, jXv, jAv, jy)
        np.testing.assert_allclose(float(step(model, Xv, Av, y)), float(jl),
                                   rtol=STEP_RTOL)
    state = dict(model.named_parameters())
    for path, want in flatten_params(jax.tree.map(np.asarray,
                                                  jparams)).items():
        got = state[".".join(str(p) for p in path)].detach().numpy()
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0)


def test_giant_init_keeps_jax_shapes_and_scales():
    """``init_giant_params``: JAX's tree shapes, w ~ N(0, 1) / sqrt(d),
    zero biases; one seed gives the same numbers twice."""
    d = 64
    model = init_giant_params(3, d, seed=5, device="cpu")
    jtree = flatten_params(jax.tree.map(np.asarray, jx_init_params(3, d)))
    state = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert {".".join(map(str, p)): v.shape for p, v in jtree.items()} == \
        {k: v.shape for k, v in state.items()}
    w = np.concatenate([state[f"layers.{i}.w"].ravel() for i in range(3)])
    assert abs(w.std() * np.sqrt(d) - 1) < 0.05 and abs(w.mean()) < 0.01
    assert all(not state[k].any() for k in state if k.endswith(".b"))
    again = init_giant_params(3, d, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_giant_plan_refuses_more_than_one_card_and_unknown_strategy():
    inp = giant_instance(8, 30, 16)
    with pytest.raises(NotImplementedError, match="S7"):
        build_giant_graph_plan(inp["acd_pad"], inp["tupleid"], inp["nnz_pad"],
                               inp["n"], 4)
    with pytest.raises(ValueError, match="strategy"):
        build_giant_graph_plan(inp["acd_pad"], inp["tupleid"], inp["nnz_pad"],
                               inp["n"], 1, strategy="allreduce")


def test_giant_entry_points_need_a_card_or_cpu():
    """Without ``device="cpu"`` and without a card, the giant entry points
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run there")
    inp = giant_instance(8, 30, 16)
    plan = build_giant_graph_plan(inp["acd_pad"], inp["tupleid"],
                                  inp["nnz_pad"], inp["n"], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_giant_params(2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_giant_graph_step(plan, 2)


def test_giant_example_runs_on_the_cpu():
    """``example/giant_graph_gpu.py --cpu`` trains a small graph and
    prints finite, falling losses; ``--devices 2`` is refused."""
    cmd = [sys.executable, str(REPO / "example" / "giant_graph_gpu.py"),
           "--cpu", "--communities", "8", "--csize", "30", "--steps", "6",
           "--lr", "0.05"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         check=True).stdout
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "on the CPU" in out
    bad = subprocess.run(cmd + ["--devices", "2"], capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "only 1" in bad.stderr
