"""The kernel variants' wrappers on the CPU (which variant each dtype and
mode selects, what they accept and refuse, that a failed launch raises and
nothing falls back), the fast NGAT projection against JAX, the segment
reductions on infinite values against JAX, and ``example/minimal_gpu.py
--fused``.

Every input comes from a numpy seed; each test states its tolerance."""

import json
import os
import re
import subprocess
import sys
import types
from contextlib import nullcontext
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygho_tpu.backend import segment as jx_segment

from pygho_tpu_torch import kernels as pt_kernels
from pygho_tpu_torch.backend import segment as pt_segment
from pygho_tpu_torch.hodata.loader import backward_orders
from pygho_tpu_torch.honn import conv as pt_conv
from pygho_tpu_torch.honn.utils import make_linear
from pygho_tpu_torch.kernels import segment_attention as k4
from pygho_tpu_torch.kernels import spspmm_sum as k1
from pygho_tpu_torch.models.serve import set_parity_numerics

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "pygho_tpu_torch" / "csrc"
BF16 = torch.bfloat16
F32 = torch.float32
VARIANTS = {("f32", F32, True), ("f32fast", F32, False), ("bf16", BF16, True),
            ("bf16fast", BF16, False)}


def _k1_inputs(rng, dtype=F32):
    U = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    acd = torch.tensor([[0, 0, 2], [1, 3, 3], [0, 2, 1]], dtype=torch.int32)
    rowptr = torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32)
    return U.to(dtype), V.to(dtype), acd, rowptr


def _entries(source, macro):
    """{entry point: (stored types..., FAST)} of a CUDA source's entry
    macros."""
    text = (CSRC / source).read_text()
    return {m.group(1): tuple(x.strip() for x in m.group(2).split(","))
            for m in re.finditer(rf"^{macro}\((\w+), \w+, ([^)]*)\)", text,
                                 re.M)}


@pytest.mark.parametrize("mod,macro,source", [
    (k1, "SPSPMM_ENTRY", "spspmm_sum.cu"),
    (k4, "SEG_ATT_ENTRY", "segment_attention.cu")], ids=["K1", "K4"])
def test_every_variant_has_its_entry_point(mod, macro, source):
    """Each role has its four variants, named by suffix, each with the
    stored dtype and mode it is picked for, each in ``KERNELS``, and each
    with an entry point of its own name in the CUDA source whose template
    arguments say the same (stored type, math mode; K1's gradient roles
    read their cotangent in f32)."""
    entries = _entries(source, macro)
    names = set()
    for base in mod.ROLES:
        for suffix, dtype, exact in VARIANTS:
            role = base.variant(dtype, exact)
            assert role.NAME == base.NAME.replace("_f32", f"_{suffix}")
            assert (role.DTYPE, role.EXACT, role.base) == (dtype, exact,
                                                           base)
            assert role.CHUNK == base.CHUNK and role.SOURCE == base.SOURCE
            assert role in pt_kernels.KERNELS
            *types_, fast = entries[role.NAME]
            assert fast == ("false" if exact else "true")
            stored = "bf16" if dtype == BF16 else "float"
            if mod is k1:
                grad = {k1.FWD: None, k1.DX: 0, k1.DA: 1}[base]
                want = ["float" if i == grad else stored for i in range(2)]
                assert types_ == want, role.NAME
            else:
                assert types_ == [stored], role.NAME
            names.add(role.NAME)
    assert names == set(entries)
    with pytest.raises(TypeError, match="no variant"):
        mod.ROLES[0].variant(torch.float16, True)


@pytest.mark.parametrize("dtype,exact", [(F32, True), (F32, False),
                                         (BF16, True), (BF16, False)])
def test_k1_wrapper_picks_the_variant(rng, monkeypatch, dtype, exact):
    """``contract`` takes bf16 operands, returns f32, and runs the plain
    version in the mode of the variant that the dtype and ``exact`` pick;
    its gradient roles take an f32 cotangent beside the stored dtype; the
    CPU launches no kernel."""
    U, V, acd, rowptr = _k1_inputs(rng, dtype)
    g = torch.ones(4, 8)
    seen = []
    real = k1.contract_plain

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(k1, "contract_plain", spy)
    before = {r.NAME: r.launches for r in pt_kernels.KERNELS}
    out = k1.contract(k1.FWD, U, V, acd, rowptr, exact)
    dX = k1.contract(k1.DX, g, V, acd, rowptr, exact)
    dA = k1.contract(k1.DA, U, g[:4], acd, rowptr, exact)
    assert seen == [exact] * 3
    assert out.dtype == dX.dtype == dA.dtype == F32
    assert before == {r.NAME: r.launches for r in pt_kernels.KERNELS}
    want = real(U.float(), V.float(), acd, 4, exact)
    assert torch.equal(out, want)


def test_k1_wrapper_refuses_mixed_operands(rng):
    """Mixed operand dtypes, a bf16 cotangent and a dtype with no variant
    are refused with a TypeError."""
    U, V, acd, rowptr = _k1_inputs(rng)
    for role, L, R in ((k1.FWD, U.bfloat16(), V),        # mixed forward
                       (k1.FWD, U, V.bfloat16()),
                       (k1.DX, U.bfloat16(), V),         # bf16 cotangent
                       (k1.DA, U, V.bfloat16()),
                       (k1.FWD, U.half(), V.half())):    # no variant
        with pytest.raises(TypeError):
            k1.contract(role, L, R, acd, rowptr)


def test_k4_wrapper_takes_bf16_and_refuses_mixed(rng):
    """``attend`` takes four bf16 operands (f32 outputs, f32 side inputs
    ``M``, ``gZ``, ``goZ``) and refuses a mixed set or a bf16 side
    input."""
    x = [torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
         for _ in range(4)]
    acd = np.array([[0, 0, 3], [1, 4, 2], [0, 4, 1]])
    tuv = torch.from_numpy(acd.astype(np.int32))
    rowptr = torch.tensor([0, 2, 2, 2, 3, 3], dtype=torch.int32)
    bf = [t.bfloat16() for t in x]
    for exact in (True, False):
        out, den, M = k4.attend(k4.FWD, *bf, tuv, rowptr, exact=exact)
        assert out.dtype == den.dtype == M.dtype == F32
        ref = k4.attention_plain(k4.FWD, *(t.float() for t in bf), tuv, 5,
                                 exact=exact)
        assert all(torch.equal(a, b) for a, b in zip((out, den, M), ref))
        gZ, goZ = k4.softmax_cotangents(torch.ones(5, 8), out, den)
        (d_a2,) = k4.attend(k4.DW, *bf, tuv, rowptr, M, gZ, goZ, exact)
        assert d_a2.dtype == F32
    with pytest.raises(TypeError):
        k4.attend(k4.FWD, bf[0], x[1], bf[2], bf[3], tuv, rowptr)
    with pytest.raises(TypeError):
        k4.attend(k4.DW, *bf, tuv, rowptr, M.bfloat16(), gZ, goZ)
    with pytest.raises(TypeError):
        k4.attend(k4.FWD, *(t.half() for t in x), tuv, rowptr)


@pytest.mark.parametrize("rc", [0, 719])
def test_a_failed_launch_raises_and_nothing_falls_back(monkeypatch, rc):
    """The launch of a variant calls that variant's own entry point, and
    where the entry point reports a CUDA error (719: a launch failure) it
    raises and counts nothing; there is no other entry point to fall back
    to.  The card's stream and device are stood in for here; on the card,
    ``chip_smoke.py`` makes every new variant's launch fail and checks the
    same."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append(name)
                return rc
            return entry

    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for mod in (k1, k4):
        for role in mod.FAST_ROLES:
            before = role.launches
            if rc:
                with pytest.raises(RuntimeError, match=role.NAME):
                    k1.launch(role, Lib(), "cuda", 1, 2)
                assert role.launches == before
            else:
                k1.launch(role, Lib(), "cuda", 1, 2)
                assert role.launches == before + 1
                role.launches = before
    assert calls == [r.NAME for r in k1.FAST_ROLES + k4.FAST_ROLES]


def test_functions_keep_dtypes_and_modes(rng, monkeypatch):
    """``SpspmmSum`` and ``SegmentAttention`` on bf16 operands: f32
    outputs, gradients in bf16, every role in the forward's mode, and the
    cotangent passed to K1's gradient roles in f32."""
    U, V, acd, rowptr = _k1_inputs(rng, BF16)
    orders = backward_orders(acd.numpy(), 4, 3)
    bwd = tuple(torch.from_numpy(x) for role in ("dx", "da")
                for x in orders[role])
    calls = []
    real = k1.contract

    def spy(role, L, R, *rest):
        calls.append((role.NAME, L.dtype, R.dtype, rest[-1]))
        return real(role, L, R, *rest)

    monkeypatch.setattr(k1, "contract", spy)
    Ug, Vg = U.clone().requires_grad_(), V.clone().requires_grad_()
    out = k1.SpspmmSum.apply(Ug, Vg, acd, rowptr, bwd, False)
    assert out.dtype == F32
    (out * 3).sum().backward()
    assert Ug.grad.dtype == Vg.grad.dtype == BF16
    assert calls == [(k1.FWD.NAME, BF16, BF16, False),
                     (k1.DX.NAME, F32, BF16, False),
                     (k1.DA.NAME, BF16, F32, False)]
    ops = [torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
           .bfloat16().requires_grad_() for _ in range(2)]
    ops.insert(2, V.clone().requires_grad_())
    ops.append(torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
               .bfloat16().requires_grad_())
    att = k4.SegmentAttention.apply(*ops, acd, rowptr, bwd, False)
    assert att.dtype == F32
    att.sum().backward()
    assert all(t.grad.dtype == BF16 for t in ops)


def test_fast_projection_matches_jax(rng):
    """``fast_projection`` (NGAT's projections under fast math on the
    card) against ``jnp.dot(x.astype(bf16), W.astype(bf16),
    preferred_element_type=f32) + b``: the same exact products of bf16
    values, summed in f32 in another order, 1e-5 of the sum of |terms|;
    and on the CPU the layer keeps f32 projections, as the JAX layer does
    on the CPU."""
    lin = make_linear(128, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lin.bias.normal_(generator=torch.Generator().manual_seed(2))
    x = rng.normal(size=(50, 128)).astype(np.float32)
    W = lin.weight.detach().numpy().T
    b = lin.bias.detach().numpy()
    ref = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(W).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32) + b)
    got = pt_conv.fast_projection(lin, torch.from_numpy(x))
    assert got.dtype == F32
    terms = np.abs(x) @ np.abs(W) + np.abs(b)
    assert (np.abs(got.detach().numpy() - ref) <= 1e-5 * terms).all()
    exact = lin(torch.from_numpy(x)).detach().numpy()
    assert np.abs(exact - ref).max() > 10 * 1e-5 * terms.max()


def test_parity_numerics_keeps_bf16_sums_in_f32():
    set_parity_numerics()
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.are_deterministic_algorithms_enabled()


# ---------------------------------------------------------------------------
# segment reductions on infinite values
# ---------------------------------------------------------------------------


def _inf_segments(rng):
    """Sorted ids over 6 segments (segment 4 empty) and 3 channels, with
    channel 1 all -inf on segment 0, channel 2 all +inf on segment 2, and
    channel 0 of segment 5 one -inf beside finite entries."""
    ids = np.array([0, 0, 0, 1, 1, 2, 2, 3, 5, 5])
    src = rng.normal(size=(ids.size, 3)).astype(np.float32)
    src[ids == 0, 1] = -np.inf
    src[ids == 2, 2] = np.inf
    src[8, 0] = -np.inf
    return src, ids, 6


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_segment_reduce_maps_infinities_as_jax(rng, aggr):
    """A maximum of -inf and a minimum of +inf come out 0, as the JAX
    ``segment_reduce`` maps them; the other entries, infinite ones of the
    other sign included, equal JAX's."""
    src, ids, segs = _inf_segments(rng)
    ref = np.asarray(jx_segment.segment_reduce(
        jnp.asarray(src), jnp.asarray(ids), segs, aggr))
    got = pt_segment.segment_reduce(torch.from_numpy(src),
                                    torch.from_numpy(ids), segs, aggr)
    assert np.array_equal(got.numpy(), ref)
    row, ch = (0, 1) if aggr == "max" else (2, 2)
    assert got[row, ch] == 0


def test_segment_softmax_shifts_an_all_neg_inf_segment_by_0(rng):
    """The segment softmax zeroes a -inf segment maximum before the shift,
    as the JAX one does: the all -inf channel gives 0, not NaN; the rest
    equal JAX's within 1e-6 (f32, the same operations)."""
    src, ids, segs = _inf_segments(rng)
    src = src.copy()
    src[ids == 2, 2] = 1.0          # +inf shifts to NaN on both sides
    ref = np.asarray(jx_segment.segment_softmax(
        jnp.asarray(src), jnp.asarray(ids), segs))
    got = pt_segment.segment_softmax(torch.from_numpy(src),
                                     torch.from_numpy(ids), segs).numpy()
    assert np.isfinite(got).all() and np.all(got[ids == 0, 1] == 0)
    assert np.abs(got - ref).max() < 1e-6


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def test_minimal_gpu_example_trains_in_fast_mode_on_the_cpu():
    """``example/minimal_gpu.py --fused --cpu`` trains an epoch (narrow,
    to stay quick) in the fast mode and prints one JSON line with
    ``log_epoch``'s fields."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "example/minimal_gpu.py", "--cpu",
                        "--fused", "--epochs", "1", "--hiddim", "16",
                        "--num_layer", "2"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.splitlines()[0])
    assert rec["epoch"] == 1 and np.isfinite(rec["trn_loss"])
    assert np.isfinite(rec["val_mae"]) and np.isfinite(rec["tst_mae"])
