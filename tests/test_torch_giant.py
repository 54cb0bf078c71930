"""The giant-graph slice of the port against the JAX package, on the CPU:
the window planner of K3 (``kernels/window_spspmm.py``) and a simulation
of its schedule, K3's contraction and gradients against
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
    """The kernel's schedule in numpy: per group, per window in order, each
    piece's sum over V read from the window; a row's first piece stores,
    later pieces add.  Checks on the way that windows lie inside V, that
    pieces stay in their group's rows and that each row is stored first
    and added to after."""
    out = np.full((p.out_rows, U.shape[1]), np.nan, np.float32)
    for g in range(p.n_groups):
        r0, r1 = p.grp_rows[g], p.grp_rows[g + 1]
        for w in range(p.grp_win[g], p.grp_win[g + 1]):
            base, rows = int(p.win_base[w]), int(p.win_rows[w])
            assert 0 <= base and base + rows <= V.shape[0]
            assert rows <= p.cap
            win = V[base:base + rows]
            for q in range(p.win_piece[w], p.win_piece[w + 1]):
                row = int(p.piece_row[q])
                add = row < 0
                row = ~row if add else row
                assert r0 <= row < r1
                s, e = p.piece_ptr[q], p.piece_ptr[q + 1]
                acc = np.zeros(U.shape[1], np.float32)
                for j in range(s, e):
                    acc = acc + U[p.u[j]] * win[p.vloc[j]]
                if add:
                    assert not np.isnan(out[row]).any(), row
                    out[row] = out[row] + acc
                else:
                    assert np.isnan(out[row]).all(), row
                    out[row] = acc
    assert not np.isnan(out).any(), "a row was never written"
    return out


def pieces_of(p):
    """Every triple as the plan lists it: (row, u, v) in piece order, and
    the piece of each triple."""
    rows = np.where(p.piece_row < 0, ~p.piece_row, p.piece_row)
    per = np.diff(p.piece_ptr)
    win_of_piece = np.repeat(np.arange(p.n_windows), np.diff(p.win_piece))
    piece = np.repeat(np.arange(p.n_pieces), per)
    v = p.vloc + p.win_base[win_of_piece[piece]]
    return np.stack([rows[piece], p.u, v]), piece


def check_invariants(p, tuv):
    t, u, v = tuv
    got, piece = pieces_of(p)
    # every triple lands in exactly one piece
    assert got.shape == tuv.shape
    key = lambda a: a[:, np.lexsort(a[::-1])]
    np.testing.assert_array_equal(key(got), key(tuv))
    # each piece reads inside its window
    win_of_piece = np.repeat(np.arange(p.n_windows), np.diff(p.win_piece))
    assert np.all(p.vloc >= 0)
    assert np.all(p.vloc < p.win_rows[win_of_piece[piece]])
    # windows lie inside V, each in one group, in ascending order there
    assert np.all(p.win_base >= 0)
    assert np.all(p.win_base + p.win_rows <= p.v_rows)
    assert np.all(p.win_rows <= p.cap)
    for g in range(p.n_groups):
        b = p.win_base[p.grp_win[g]:p.grp_win[g + 1]]
        r = p.win_rows[p.grp_win[g]:p.grp_win[g + 1]]
        assert np.all(b[1:] >= b[:-1] + r[:-1])
    # groups cover the output rows in order; every row has one first
    # piece, and a row inside one piece keeps its triples' given order
    assert p.grp_rows[0] == 0 and p.grp_rows[-1] == p.out_rows
    assert np.all(np.diff(p.grp_rows) > 0)
    firsts = p.piece_row[p.piece_row >= 0]
    np.testing.assert_array_equal(np.sort(firsts), np.arange(p.out_rows))
    rows = np.where(p.piece_row < 0, ~p.piece_row, p.piece_row)
    n_pieces = np.bincount(rows, minlength=p.out_rows)
    ptr = np.r_[0, np.cumsum(np.bincount(t, minlength=p.out_rows))]
    for q in np.flatnonzero(n_pieces[rows] == 1):
        r = rows[q]
        s, e = p.piece_ptr[q], p.piece_ptr[q + 1]
        np.testing.assert_array_equal(got[1:, s:e],
                                      tuv[1:, ptr[r]:ptr[r + 1]])


def test_planner_invariants_and_merging():
    """The planner on the pv test's community workload: every triple in
    one piece, windows inside V, and the windows merge: each community's
    256-row edge block is staged once a group, so the rows staged are far
    fewer than the triples' V reads, and far fewer windows are staged than
    there are 64-row output blocks (each of which a per-block window, as
    the JAX classic plan has, would stage on its own)."""
    rng = np.random.default_rng(0)
    tuv, n_out, n_v = community_triples(rng)
    plan = k3.build_window_plan(tuv, n_out, n_out, n_v)
    check_invariants(plan, tuv)
    assert plan.n_windows < (n_out // 64) / 4, plan.n_windows
    assert int(plan.win_rows.sum()) < tuv.shape[1] / 2
    # no row of this workload spans two windows
    assert plan.n_pieces == n_out


def test_planner_schedule_simulation_matches_plain():
    """Running the plan's schedule as the kernel does (numpy) gives the
    plain contraction, on edge cases: empty rows, a row whose triples span
    three and more windows, a window at the end of V, single-row groups, a
    D not a multiple of 4 or of 32, and no triples at all.  f32 sums of a
    few products of order 1, in window order: within 1e-5."""
    rng = np.random.default_rng(1)
    out_rows, u_rows, v_rows, D = 40, 30, 200, 13
    t = np.sort(rng.integers(0, out_rows, 300))
    t = t[(t != 3) & (t != 17)]                       # empty rows
    u = rng.integers(0, u_rows, t.size)
    v = rng.integers(0, v_rows, t.size)
    v[t == 5] = np.arange((t == 5).sum()) * 37 % v_rows  # a spread row
    v[-1] = v_rows - 1                                # the end of V
    tuv = np.stack([t, u, v])
    U = rng.normal(size=(u_rows, D)).astype(np.float32)
    V = rng.normal(size=(v_rows, D)).astype(np.float32)
    ref = contract_plain(torch.from_numpy(U), torch.from_numpy(V),
                         torch.from_numpy(tuv), out_rows).numpy()
    n_empty = out_rows - np.unique(t).size
    for cap, gt in ((16, 64), (8, 1), (200, 10 ** 6), (40, 32)):
        plan = k3.build_window_plan(tuv, out_rows, u_rows, v_rows, cap=cap,
                                    group_triples=gt)
        check_invariants(plan, tuv)
        np.testing.assert_allclose(run_schedule(plan, U, V), ref, atol=1e-5)
        if cap <= 16:
            rows = np.where(plan.piece_row < 0, ~plan.piece_row,
                            plan.piece_row)
            assert np.bincount(rows)[5] >= 3     # row 5 spans 3+ windows
        if gt == 1:
            # a group a row; an empty row joins the next row's group
            assert plan.n_groups == out_rows - n_empty
    empty = k3.build_window_plan(np.zeros((3, 0), np.int64), 7, 4, 5)
    np.testing.assert_array_equal(run_schedule(empty, U[:4], V[:5]),
                                  np.zeros((7, D), np.float32))


def test_planner_on_the_giant_graph_groups_communities():
    """On an 8x30 community graph (RCM, hop-1 tuples), the three roles'
    plans hold the invariants, and a window serves many rows: fewer
    windows than a tenth of the pieces."""
    rng = np.random.default_rng(0)
    n = 8 * 30
    g = rcm_reorder(Graph(x=np.zeros((n, 1)), edge_index=community_graph(
        rng, 8, 30), edge_attr=None).coalesced())
    tup, acd = hop1(indexing, g.edge_index, n)
    nnz = tup.shape[1]
    plans = k3.build_window_plans(acd, nnz, g.num_edges, nnz)
    a, c, d = acd
    orders = (acd, np.stack([c, a, d])[:, np.argsort(c, kind="stable")],
              np.stack([d, c, a])[:, np.argsort(d, kind="stable")])
    for plan, tuv in zip(plans, orders):
        check_invariants(plan, tuv)
        assert plan.n_windows < plan.n_pieces / 10


def test_planner_refuses_bad_triples():
    tuv = np.array([[1, 0], [0, 0], [0, 0]])
    with pytest.raises(ValueError, match="not sorted"):
        k3.build_window_plan(tuv, 2, 1, 1)
    with pytest.raises(ValueError, match="out of range"):
        k3.build_window_plan(np.array([[0], [0], [5]]), 2, 1, 1)
    with pytest.raises(ValueError, match="at least 1"):
        k3.build_window_plan(np.array([[0], [0], [0]]), 2, 1, 1, cap=0)


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

    plans = tuple(p.to("cpu") for p in k3.build_window_plans(
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
    plans = tuple(p.to("cpu") for p in k3.build_window_plans(
        acd, n_out, n_v, n_out))
    calls = []
    real = k3.contract

    def spy(r, a, b, plan):
        calls.append((r.NAME, plan))
        return real(r, a, b, plan)

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
    host = k3.build_window_plans(acd, n_out, n_v, n_out)
    plans = tuple(p.to("cpu") for p in host)
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    with pytest.raises(RuntimeError, match="WindowSpspmmSum"):
        k3.contract(k3.FWD, Ut.clone().requires_grad_(), Vt, plans[0])
    with pytest.raises(TypeError):
        k3.contract(k3.FWD, Ut.double(), Vt, plans[0])
    with pytest.raises(ValueError, match="plan is for"):
        k3.contract(k3.FWD, Ut[:-1], Vt, plans[0])
    with pytest.raises(ValueError, match="WindowPlan.to"):
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
