"""K3's fast numerics mode and the giant graph trained in it, against the
JAX package, on the CPU: K3's three ``*_f32fast`` roles (their plain
version, the card's kernels' oracle) against ``fused_spspmm_strip(...,
exact=False)`` on persistent-V-window plans, which runs the TPU kernel
``_strip_kernel_pv`` in interpret mode; and the giant-graph training step
with the fast flag off, for every strategy, against JAX's
``make_giant_graph_step`` on a one-device mesh under
``set_fused_math(False)``.

In JAX only ``overlapped_fused`` contracts on a Pallas kernel, which
follows the flag; the other strategies contract with XLA segment sums in
f32 whatever it says.  So the port's fast step must differ from its exact
step for ``overlapped_fused`` alone.  ``set_fused_math`` is global in both
packages: every test that changes it restores it in the ``fast``
fixture's ``finally``.

Every input comes from a numpy seed; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.kernels import strip_spspmm as jx_strip
from pygho_tpu.kernels.fused_spspmm import get_fused_math as jx_get_fused_math
from pygho_tpu.kernels.fused_spspmm import set_fused_math as jx_set_fused_math
from pygho_tpu.parallel import build_giant_graph_plan as jx_build_plan
from pygho_tpu.parallel import init_giant_params as jx_init_params
from pygho_tpu.parallel import make_giant_graph_step as jx_make_step
from pygho_tpu.parallel import make_mesh

from pygho_tpu_torch import kernels as pt_kernels
from pygho_tpu_torch.kernels import window_spspmm as k3
from pygho_tpu_torch.parallel import (build_giant_graph_plan,
                                      init_giant_params,
                                      make_giant_graph_step)
from pygho_tpu_torch.weights import flatten_params, load_jax_params

from test_torch_giant import _pv_case, giant_instance

# K3's fast roles against the JAX pv kernel in fast mode: both round each
# operand (the cotangent too) and each product to bf16 at the same points,
# so they differ only in the order of the f32 sums of 2 to 4 terms of
# order 1 (the TPU kernel sums one-hot products): the exact roles' 1e-4
K3_FAST_TOL = 1e-4
# the giant step against JAX's, in either mode: f32 without TF32 on both,
# through three layers, the root pooling and the readout, summed in other
# orders (tests/test_torch_giant.py).  In fast mode both make the same
# roundings; an operand whose f32 value differs in its last bits between
# the packages could round to bf16 the other way, but the 8x30 graph shows
# none: the losses differ by 1.1e-7 relative and the parameters by 1.4e-7,
# where the fast and exact steps differ by 5.8e-5 relative.  So the exact
# step's tolerances hold the fast step too, and they tell the two modes
# apart
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture()
def fast():
    """Fast math in both packages for the test, the previous modes
    restored after it, whatever happens."""
    was = jx_get_fused_math(), pt_kernels.get_fused_math()
    jx_set_fused_math(False)
    pt_kernels.set_fused_math(False)
    try:
        yield
    finally:
        jx_set_fused_math(was[0])
        pt_kernels.set_fused_math(was[1])


def test_k3_fast_roles_match_jax_pv_kernel(fast):
    """``WindowSpspmmSum(..., exact=False)``: the forward role, and the dX
    and dA roles of its backward, against ``fused_spspmm_strip`` in fast
    mode on pv plans (``_strip_kernel_pv`` in interpret mode), within
    K3_FAST_TOL; and each differs from the exact mode by far more than
    that, so the fast math is what is compared."""
    acd, n_out, n_v, U, V, W = _pv_case()
    gpv = (256, 512, 128, 128, 512, 1, 16, 1)
    ppv = jx_strip.build_spspmm_strip_plans(acd, n_out, n_v, n_out,
                                            {"fwd": gpv, "dx": gpv,
                                             "da": gpv})
    assert ppv[0].v_persistent

    def jx_loss(a, b):
        out = jx_strip.fused_spspmm_strip(a, b, *ppv, None, False)[:n_out]
        return (out * jnp.asarray(W)).sum(), out

    (_, jx_out), (jx_gu, jx_gv) = jax.value_and_grad(
        jx_loss, (0, 1), has_aux=True)(jnp.asarray(U), jnp.asarray(V))

    plans = tuple(p.to("cpu") for p in k3.build_chunk_plans(
        acd, n_out, n_v, n_out))
    got, exact = [], []
    for mode in (False, True):
        Ut = torch.from_numpy(U).requires_grad_()
        Vt = torch.from_numpy(V).requires_grad_()
        out = k3.WindowSpspmmSum.apply(Ut, Vt, plans, mode)
        (out * torch.from_numpy(W)).sum().backward()
        (exact if mode else got).extend(
            [out.detach().numpy(), Ut.grad.numpy(), Vt.grad.numpy()])
    for name, mine, want, ex in zip(("out", "grad_U", "grad_V"), got,
                                    (jx_out, jx_gu, jx_gv), exact):
        np.testing.assert_allclose(mine, np.asarray(want), atol=K3_FAST_TOL,
                                   rtol=0, err_msg=name)
        assert np.abs(mine - ex).max() > 100 * K3_FAST_TOL, name


@pytest.mark.parametrize("role", ["fwd", "dx", "da"])
def test_k3_fast_role_is_the_rounded_plain_contraction(role):
    """Each fast role's plain version rounds both operands and each
    product to bf16 and sums the products in f32 in triple order, bit for
    bit (the roundings of K1's fast variant), on the role's own plan."""
    acd, n_out, n_v, U, V, _ = _pv_case()
    plans = dict(zip(("fwd", "dx", "da"), (p.to("cpu") for p in
                                           k3.build_chunk_plans(
                                               acd, n_out, n_v, n_out))))
    plan = plans[role]
    rng = np.random.default_rng(1)
    Ut = torch.from_numpy(rng.normal(size=(plan.u_rows, U.shape[1]))
                          .astype(np.float32))
    Vt = torch.from_numpy(rng.normal(size=(plan.v_rows, U.shape[1]))
                          .astype(np.float32))
    r = {"fwd": k3.FWD, "dx": k3.DX, "da": k3.DA}[role]
    got = k3.contract(r, Ut, Vt, plan, exact=False)
    t, u, v = plan.tuv.long()
    b = lambda x: x.to(torch.bfloat16).float()
    want = torch.zeros_like(got)
    terms = b(b(Ut)[u] * b(Vt)[v])
    for i in range(t.shape[0]):
        want[t[i]] += terms[i]
    assert torch.equal(got, want)
    assert not torch.equal(got, k3.contract(r, Ut, Vt, plan))


def test_k3_fast_variants_are_listed_and_named():
    """``FAST_ROLES`` are the three ``*_f32fast`` roles, in ``KERNELS``,
    each the f32 fast variant of its exact role, in the same source."""
    assert [r.NAME for r in k3.FAST_ROLES] == [
        "window_spspmm_fwd_f32fast", "window_spspmm_dx_f32fast",
        "window_spspmm_da_f32fast"]
    for base, fast_role in zip(k3.ROLES, k3.FAST_ROLES):
        assert base.variant(torch.float32, False) is fast_role
        assert fast_role.variant(torch.float32, True) is base
        assert fast_role.SOURCE == base.SOURCE and not fast_role.EXACT
        assert "exact=False" in fast_role.REPLACES
        assert fast_role in pt_kernels.KERNELS
    with pytest.raises(TypeError, match="no variant"):
        k3.FWD.variant(torch.bfloat16, True)


def _steps(strategy, fast_mode, d=16, L=3, lr=0.05):
    """JAX's and the port's giant steps on an 8x30 community graph, with
    JAX's parameters carried across, each built with the fast flag as
    ``fast_mode`` says (the flags restored before returning)."""
    inp = giant_instance(8, 30, d)
    n, nnz_pad = inp["n"], inp["nnz_pad"]
    n_real = n - 10
    was = jx_get_fused_math(), pt_kernels.get_fused_math()
    jx_set_fused_math(not fast_mode)
    pt_kernels.set_fused_math(not fast_mode)
    try:
        mesh = make_mesh((1,), ("sp",), devices=jax.devices()[:1])
        jplan = jx_build_plan(inp["acd_pad"], inp["tupleid"], nnz_pad, n, 1,
                              strategy=strategy,
                              n_edge_rows=inp["Av"].shape[0], plan_dim=d)
        jparams = jx_init_params(L, d, seed=3)
        _, jstep = jx_make_step(mesh, jplan, L, lr=lr, n_real=n_real)
        jXv, jAv, jy = (jnp.asarray(inp[k]) for k in ("Xv", "Av", "y"))
        jlosses = []
        for _ in range(3):
            jparams, jl = jstep(jparams, jXv, jAv, jy)
            jlosses.append(float(jl))

        plan = build_giant_graph_plan(inp["acd_pad"], inp["tupleid"],
                                      nnz_pad, n, 1, strategy=strategy,
                                      n_edge_rows=inp["Av"].shape[0],
                                      plan_dim=d)
        model = init_giant_params(L, d, device="cpu")
        load_jax_params(model, flatten_params(jax.tree.map(
            np.asarray, jx_init_params(L, d, seed=3))))
        _, step = make_giant_graph_step(plan, L, lr=lr, n_real=n_real,
                                        device="cpu")
    finally:
        jx_set_fused_math(was[0])
        pt_kernels.set_fused_math(was[1])
    Xv, Av, y = (torch.from_numpy(inp[k]) for k in ("Xv", "Av", "y"))
    losses = [float(step(model, Xv, Av, y)) for _ in range(3)]
    jflat = flatten_params(jax.tree.map(np.asarray, jparams))
    return losses, model, jlosses, jflat


@pytest.mark.parametrize("strategy", ["overlapped", "ring", "reduce_scatter",
                                      "overlapped_fused"])
def test_giant_fast_step_matches_jax_one_device_mesh(strategy):
    """With the fast flag off in both packages, three SGD steps on a
    one-device mesh: the port's losses and parameters against JAX's,
    within STEP_RTOL and PARAM_ATOL.  Against the port's exact run:
    ``overlapped_fused`` differs, every other strategy gives the same bits,
    as in JAX, where the same holds (checked here too)."""
    losses, model, jlosses, jflat = _steps(strategy, True)
    ex_losses, ex_model, jex_losses, _ = _steps(strategy, False)
    fused = strategy == "overlapped_fused"
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_RTOL)
    state = dict(model.named_parameters())
    for path, want in jflat.items():
        got = state[".".join(str(p) for p in path)].detach().numpy()
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0)
    same = losses == ex_losses and all(
        torch.equal(p, q) for p, q in zip(model.parameters(),
                                          ex_model.parameters()))
    assert same != fused
    assert (jlosses == jex_losses) != fused


def test_giant_step_reads_the_flag_when_built(monkeypatch):
    """The math mode is read when the step is built, as JAX reads it when
    it traces: a step built with the flag off runs the fast forward and
    dX roles under ``overlapped_fused`` after the flag is restored, and a
    step built with it on stays exact after it is turned off."""
    inp = giant_instance(8, 30, 16)
    plan = build_giant_graph_plan(inp["acd_pad"], inp["tupleid"],
                                  inp["nnz_pad"], inp["n"], 1,
                                  strategy="overlapped_fused",
                                  n_edge_rows=inp["Av"].shape[0])
    calls = []
    real = k3.contract

    def spy(role, U, V, p, exact=True):
        calls.append(role.variant(torch.float32, exact).NAME)
        return real(role, U, V, p, exact)

    monkeypatch.setattr(k3, "contract", spy)
    Xv, Av, y = (torch.from_numpy(inp[k]) for k in ("Xv", "Av", "y"))
    model = init_giant_params(2, 16, device="cpu")
    was = pt_kernels.get_fused_math()
    try:
        pt_kernels.set_fused_math(False)
        _, fast_step = make_giant_graph_step(plan, 2, device="cpu")
        pt_kernels.set_fused_math(True)
        _, exact_step = make_giant_graph_step(plan, 2, device="cpu")
        pt_kernels.set_fused_math(False)
        fast_step(model, Xv, Av, y)
        assert calls == ["window_spspmm_fwd_f32fast"] * 2 \
            + ["window_spspmm_dx_f32fast"] * 2
        calls.clear()
        exact_step(model, Xv, Av, y)
        assert calls == ["window_spspmm_fwd_f32"] * 2 \
            + ["window_spspmm_dx_f32"] * 2
    finally:
        pt_kernels.set_fused_math(was)
    assert plan.strategy == "overlapped_fused"


def test_giant_example_runs_fast_on_the_cpu():
    """``example/giant_graph_gpu.py --cpu --strategy overlapped_fused
    --fast`` trains in the fast mode and says so; under ``overlapped``
    ``--fast`` leaves the contraction exact, as the JAX script's help
    says (overlapped_fused only)."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "example" \
        / "giant_graph_gpu.py"
    base = [sys.executable, str(script), "--cpu", "--communities", "8",
            "--csize", "30", "--steps", "6", "--lr", "0.05", "--fast"]
    out = {}
    for strategy in ("overlapped_fused", "overlapped"):
        out[strategy] = subprocess.run(
            base + ["--strategy", strategy], capture_output=True, text=True,
            timeout=300, check=True).stdout
    assert "fast math" in out["overlapped_fused"]
    assert "exact math" in out["overlapped"]
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out["overlapped_fused"].splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
