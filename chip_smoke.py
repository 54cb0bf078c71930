"""Smoke run of the PyTorch / CUDA port (``pygho_tpu_torch``) on one CUDA
card.

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds every kernel of the main paths from
   ``pygho_tpu_torch/csrc`` with ``nvcc`` (all sources at once);
3. kernels: holds each kernel (K1's forward, dX and dA roles; K5's
   forward, dA and dX roles; K4's forward, dw, dc and dv roles; K3's
   forward, dX and dA roles) against its plain PyTorch version on the
   card, at the shapes the main paths give it (K1 and K4: one 128-graph
   batch of ``synthetic_zinc("val")``, ``KhopSampler(hop=3)``, D = 128;
   K5: one 128-graph batch, ``spdsampler(hop=4)``, (128, 32, 32, 128); K3:
   the giant graph of phase 10, D = 128) and on edge cases, printing for
   K3 and K5 whether they agree bit for bit, holds the ``SpspmmSum``,
   ``ChannelwiseBmm``, ``SegmentAttention`` and ``WindowSpspmmSum``
   gradients against autograd through the plain versions, and times
   kernels, plain versions, K3 beside K1 on the same triples and, for K5,
   the library's ``torch.einsum``;
4. serving: serves NGNN-SS 6x128 (weights from a seed) through the port's
   ``SpPredictor`` over three requests, checks that every batch went through
   the forward kernel, that the outputs are finite, ordered and repeatable,
   and that they match the same model run on the CPU with the plain
   versions;
5. training: trains NGNN-SS 6x128 (weights from a seed) for ten AdamW steps
   on shuffled 128-graph batches of ``synthetic_zinc("train")`` through the
   port's ``make_sparse_steps``, checks that every step launched each K1
   role six times, that the losses are finite, that a second run gives the
   same bits, and that the CPU run with the plain versions gives the same
   losses within ``TRAIN_RTOL``; then prints graphs/s trained and one
   step's breakdown;
6. dense serving: serves PPGN-DD 6x128 (``runs/converged/PPGN_dense.json``,
   weights from a seed) through ``MaPredictor`` over three requests, with
   the checks of phase 4 and six K5 forward launches per batch;
7. dense training: trains PPGN-DD 6x128 for ten AdamW steps through
   ``make_dense_steps``, checks 6 + 6 + 6 K5 launches a step, finite
   losses, a bitwise-identical second run and the CPU's losses over the
   first ``DENSE_CPU_STEPS`` steps; prints graphs/s trained and the peak
   device memory;
8. NGAT serving: serves NGAT-SS 6x128 (``runs/converged/NGAT_sparse.json``,
   weights from a seed) through ``SpPredictor`` as phase 4 does, with six
   K4 forward launches per batch and no K1 launch;
9. NGAT training: trains NGAT-SS 6x128 for ten AdamW steps at lr 1e-3
   through ``make_sparse_steps`` as phase 5 does, with six launches of
   each K4 role a step, and the CPU's losses over the first
   ``NGAT_CPU_STEPS`` steps;
10. giant training: trains one giant graph (``example/giant_graph_gpu.py``
   at 200 communities x 100 nodes, hiddim 128, 3 layers, lr 1e-4) for ten
   SGD steps through ``parallel/giant.py``, checks three K3 forward and
   three dX launches a step and nothing else, finite losses, a
   bitwise-identical second run and the CPU's losses over
   ``GIANT_CPU_STEPS`` steps; prints ms a step, the plan's host time and
   the peak device memory.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the last line.  It imports nothing of JAX.
"""

import copy
import faulthandler
import json
import math
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent

# the run must end well inside the 1200 s the harness allows: past this,
# dump every thread's stack and exit non-zero
WATCHDOG_S = 900

KEY = "X___X___1___A___0"
SEED = 42                 # synthetic_zinc's seed, as in the JAX package
MLPD = {"norm": "bn", "act": "silu", "dp": 0.0}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
# kernel vs plain version on the card: the same rounded f32 products, summed
# in triple order by the kernel and by atomics in the plain version; the
# rounding of an f32 sum grows with the magnitudes of its terms, so the
# tolerance of each output is KERNEL_RTOL * sum |U[c] * V[d]| of its row
KERNEL_RTOL = 1e-5
# served predictions, card vs CPU: f32 without TF32 on both, sums over
# tuples, nodes and graphs in another order through six layers, on
# predictions of order 1
SERVE_TOL = 1e-4
# the same graph served twice on the card, in batches of other sizes, where
# matrix products of other shapes may take other cuBLAS kernels
REPEAT_TOL = 1e-5
# training: NGNN-SS 6x128, AdamW at lr 1e-3 (example/minimal_tpu.py), ten
# steps on the card and as many on the CPU
TRAIN_STEPS = 10
CPU_STEPS = 10
TRAIN_LR = 1e-3
# the sparse configurations, weights from seed 0: NGNN-SS 6x128 as
# example/minimal_tpu.py builds it; NGAT-SS 6x128 as
# runs/converged/NGAT_sparse.json trains it (6 layers x 128,
# KhopSampler(hop=3), batch 128, aggr, npool and lpool sum, outlayer 4,
# mlplayer 2, normparam 0.194), with example/zinc_tpu.py's MLP settings.
# Both train at lr 1e-3: at the converged run's 1e-2 the reference itself
# goes NaN within epochs
SPARSE = {
    "NGNN": dict(num_layer=6, hiddim=128, mlp=MLPD),
    "NGAT": dict(num_layer=6, hiddim=128, aggr="sum", npool="sum",
                 lpool="sum", outlayer=4,
                 mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                      "normparam": 0.194, "numlayer": 2, "tailact": True}),
}
# the kernel source each sparse configuration's layers launch, six times a
# batch for each role
SPARSE_SOURCE = {"NGNN": "spspmm_sum.cu", "NGAT": "segment_attention.cu"}
# the CPU repeats this many of NGAT's ten steps, each gathering and
# exponentiating some 60,000 x 128 scores a layer with the plain K4
NGAT_CPU_STEPS = 5
# K4 vs its plain version on the card: the same rounded products, maximum
# and differences, summed in triple order by the kernel and in another
# order by the plain version's index_add_, and expf against torch.exp (both
# within 2 ulp); the tolerance of each output is ATT_RTOL * its sum of
# |terms| (k4_terms)
ATT_RTOL = 1e-5
# per-step losses, card vs CPU: f32 without TF32 on both, sums in another
# order through forward, backward and ten AdamW steps (the JAX package's
# own ten-step differential against the torch reference held 3e-4)
TRAIN_RTOL = 1e-3

# PPGN-DD 6x128 as runs/converged/PPGN_dense.json trains it (6 layers x
# 128, mlplayer 2, outlayer 4, npool sum, lpool mean, normparam 0.185,
# spdsampler hop 4, batch 128), with example/zinc_tpu.py's MLP settings
DENSE = dict(num_layer=6, hiddim=128, npool="sum", lpool="mean",
             outlayer=4, mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                              "normparam": 0.185, "numlayer": 2,
                              "tailact": True})
DENSE_HOP = 4
DENSE_LR = 4.5e-3            # the converged run's base learning rate
# served predictions, card vs CPU: as SERVE_TOL, through six layers whose
# channel-wise products each sum 32 terms
DENSE_SERVE_TOL = 1e-4
# the CPU repeats this many of the card's ten steps: a PPGN-DD 6x128 step
# at batch 128 takes tens of seconds on the CPU with the plain K5
DENSE_CPU_STEPS = 3
DENSE_TRAIN_RTOL = 1e-3
# the giant graph of example/giant_graph_gpu.py as example/giant_graph_tpu.py
# runs it on one chip: bench_scaling.py's 200x100 community graph (RCM,
# hop-1 tuples, 556,515 contraction triples), hiddim 128, 3 layers, plain
# SGD at lr 1e-4, ten steps on the card, twice, and on the CPU
GIANT = dict(communities=200, csize=100, hiddim=128, num_layer=3, lr=1e-4)
GIANT_STEPS = 10
GIANT_CPU_STEPS = 10
# per-step losses, card vs CPU: f32 without TF32 on both; the loss is a mean
# over 20,000 nodes of squared errors whose sums (the contraction, the root
# pooling, the readout) run in other orders, each off by a few f32 ulps;
# plain SGD at lr 1e-4 moves the parameters by 1e-4 of their gradients, so
# a difference does not grow as AdamW's normalised steps let it grow (the
# other sparse paths' TRAIN_RTOL of 1e-3); 1e-4 relative leaves a margin of
# about 100 over f32 rounding of such a mean
GIANT_RTOL = 1e-4
# K5 vs its plain version on the card: the same rounded f32 products summed
# in the same order, so they should agree exactly; the tolerance of each
# output is K5_RTOL * sum |A[b,i,k,d] * X[b,k,j,d]| over its k
K5_RTOL = 1e-6


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(fn, flush, reps=30, warmup=5, settle=True):
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    ``flush`` has evicted the L2 cache (outside the timed span).  With
    ``settle``, the card then spins in place for about 0.3 ms, with no
    memory traffic, so the host has queued ``fn``'s launches before the
    start event is reached: the time is the kernels', not the host's (a
    wrapper's checks can take longer than the flush).  A step's time,
    whose host gaps count, is taken with ``settle=False``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        if settle:
            torch.cuda._sleep(500_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound(tuv, out_rows, D):
    """The least time of one K1 role on the card: every referenced row of
    its two operands read once, its index arrays and row pointer read
    once, every output row written once, against its f32 operations.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    import torch

    k = tuv.shape[1]
    u_read = int(torch.unique(tuv[1]).numel())
    v_read = int(torch.unique(tuv[2]).numel())
    nbytes = (u_read + v_read + out_rows) * D * 4 + k * 2 * 4 \
        + (out_rows + 1) * 4
    flops = 2 * k * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def check_k1(datas, dev, rng, flush):
    """K1's three roles at the main path's shapes and on edge cases,
    against their plain version on the card, and ``SpspmmSum``'s
    gradients against autograd through the plain version.  Returns the
    roles' lines of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata.loader import SpDataloader, backward_orders
    from pygho_tpu_torch.kernels import spspmm_sum as k1

    batch = next(iter(SpDataloader(datas, 128, [KEY], backward=True)))
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    n_t, n_e = int(batch["num_tuples"]), int(batch["num_edges"])
    D = 128

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    U, V, g = operand(nt, n_t), operand(ne, n_e), operand(nt, n_t)
    t = {name: torch.from_numpy(batch[f"{KEY}___{name}"]).to(dev)
         for name in ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da",
                      "rowptr_da")}
    # each role's operands at the main path's shapes: forward
    # out[a] += U[c] * V[d], dX dU[c] += g[a] * V[d], dA dV[d] += U[c] * g[a]
    main = {k1.FWD: (U, V, t["acd"], t["rowptr"]),
            k1.DX: (g, V, t["acd_dx"], t["rowptr_dx"]),
            k1.DA: (U, g, t["acd_da"], t["rowptr_da"])}

    def compare(role, U, V, tuv, rowptr):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance); raises where an output row with no triples is not 0,
        or where the kernel's bits differ from the plain version's (both
        sum each row's rounded products in triple order)."""
        n = rowptr.shape[0] - 1
        out = k1.contract(role, U, V, tuv, rowptr)
        ref = k1.contract_plain(U, V, tuv, n)
        mag = k1.contract_plain(U.abs(), V.abs(), tuv, n)
        sync()
        if out.numel() == 0:
            return 0.0, 0.0
        empty = (rowptr[1:] == rowptr[:-1])
        if bool((out[empty] != 0).any()):
            raise AssertionError(f"{role.NAME} wrote a non-zero empty row")
        if not torch.equal(out, ref):
            raise AssertionError(f"{role.NAME} is not bit for bit equal to "
                                 f"its plain version")
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()))

    errs = {}
    for role, args in main.items():
        err, ratio = compare(role, *args)
        errs[role] = err
        print(f"{role.NAME} main shape: {args[2].shape[1]} triples, "
              f"operands {tuple(args[0].shape)} and {tuple(args[1].shape)}, "
              f"out {(args[3].shape[0] - 1, D)}; bit for bit equal to the "
              f"plain version (max abs err {err:.3e}, {ratio:.3f} of the "
              f"tolerance {KERNEL_RTOL:g} * sum |terms|)")
        if not ratio <= 1.0:
            raise AssertionError(f"{role.NAME} disagrees with its plain "
                                 f"version: {err}")

    # edge cases, for every role: empty rows, one row with many triples, a
    # padded tail, D = 16, a D that is not a multiple of 4 and an
    # unaligned left operand (both take the scalar loop), no triples; short
    # rows with a run of 130 empty rows mid-array, rows of 33 and 120
    # triples over several chunks, 5 triples past a multiple of 32 (every
    # chunk size); and the backward orders of a forward case, as the
    # loader builds them
    def case(role, D, rows, u_rows, v_rows, out_rows, misalign=False):
        t_ = np.sort(rows).astype(np.int64)
        tuv = np.stack([t_, rng.integers(0, u_rows, t_.size),
                        rng.integers(0, v_rows, t_.size)]).astype(np.int32)
        rp = np.zeros(out_rows + 1, np.int32)
        rp[1:] = np.cumsum(np.bincount(t_, minlength=out_rows))
        Ut = torch.from_numpy(rng.normal(size=(u_rows, D))
                              .astype(np.float32)).to(dev)
        if misalign:
            flat = torch.empty(u_rows * D + 1, device=dev)[1:]
            Ut = flat.view(u_rows, D).copy_(Ut)
        Vt = torch.from_numpy(rng.normal(size=(v_rows, D))
                              .astype(np.float32)).to(dev)
        return compare(role, Ut, Vt, torch.from_numpy(tuv).to(dev),
                       torch.from_numpy(rp).to(dev))

    heavy = np.concatenate([np.full(2000, 5), rng.integers(0, 900, 3000)])
    heavy = heavy[(heavy != 3) & (heavy != 700)]
    lens = rng.integers(0, 6, 1000)
    lens[300:430] = 0
    lens[[7, 8, 9]] = (120, 33, 32)
    lens[-1] += (5 - lens.sum()) % 32
    runs = np.repeat(np.arange(1000), lens)
    cases = {
        "empty + heavy rows, D=128": (128, heavy, 500, 400, 1024),
        "empty + heavy rows, D=16": (16, heavy, 500, 400, 1024),
        "D=13 (scalar loop)": (13, heavy, 500, 400, 1024),
        "unaligned U, D=128 (scalar loop)": (128, heavy, 500, 400, 1024,
                                             True),
        "no triples": (128, np.zeros(0, np.int64), 10, 10, 64),
        "short rows, 130 empty rows mid-array, rows over several chunks, "
        "k = 5 mod 32, D=128": (128, runs, 500, 400, 1000),
    }
    for role in k1.ROLES:
        for name, args in cases.items():
            e, r = case(role, *args)
            print(f"{role.NAME} edge case {name}: bit for bit equal (max "
                  f"abs err {e:.3e}, {r:.3f} of the tolerance)")
            if not r <= 1.0:
                raise AssertionError(f"{role.NAME} edge case {name} "
                                     f"disagrees: {e}")
    # the heavy forward case's backward orders: a 2,000-triple forward row
    # spreads over the backward roles' rows
    a = np.sort(heavy)
    acd = np.stack([a, rng.integers(0, 500, a.size),
                    rng.integers(0, 400, a.size)])
    Xc = torch.from_numpy(rng.normal(size=(500, D)).astype(np.float32)) \
        .to(dev)
    Ac = torch.from_numpy(rng.normal(size=(400, D)).astype(np.float32)) \
        .to(dev)
    gc = torch.from_numpy(rng.normal(size=(1024, D)).astype(np.float32)) \
        .to(dev)
    orders = {r: [torch.from_numpy(x).to(dev) for x in v]
              for r, v in backward_orders(acd, 500, 400).items()}
    for role, args in ((k1.DX, (gc, Ac, *orders["dx"])),
                       (k1.DA, (Xc, gc, *orders["da"]))):
        e, r = compare(role, *args)
        print(f"{role.NAME} edge case backward orders of the heavy case: "
              f"bit for bit equal (max abs err {e:.3e}, {r:.3f} of the "
              f"tolerance)")
        if not r <= 1.0:
            raise AssertionError(f"{role.NAME} on backward orders: {e}")

    # SpspmmSum's gradients on the card against autograd through the
    # plain version, for a random cotangent W
    W = operand(nt, n_t)
    bwd = (t["acd_dx"], t["rowptr_dx"], t["acd_da"], t["rowptr_da"])
    Uk, Vk = U.clone().requires_grad_(), V.clone().requires_grad_()
    (k1.SpspmmSum.apply(Uk, Vk, t["acd"], t["rowptr"], bwd) * W) \
        .sum().backward()
    Up, Vp = U.clone().requires_grad_(), V.clone().requires_grad_()
    (k1.contract_plain(Up, Vp, t["acd"], nt) * W).sum().backward()
    with torch.no_grad():
        mags = (k1.contract_plain(W.abs(), V.abs(), t["acd_dx"], nt),
                k1.contract_plain(U.abs(), W.abs(), t["acd_da"], ne))
    for what, got, ref, mag in (("grad_U", Uk.grad, Up.grad, mags[0]),
                                ("grad_V", Vk.grad, Vp.grad, mags[1])):
        diff = (got - ref).abs()
        ratio = float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max())
        print(f"SpspmmSum {what} vs autograd through the plain version: "
              f"max abs err {float(diff.max()):.3e}, {ratio:.3f} of the "
              f"tolerance")
        if not ratio <= 1.0:
            raise AssertionError(f"SpspmmSum {what} disagrees")

    report = []
    for role, args in main.items():
        tuv, rowptr = args[2], args[3]
        out_rows = rowptr.shape[0] - 1
        ms = time_ms(lambda: k1.contract(role, *args), flush)
        # the plain version with atomic index_add_ (deterministic
        # algorithms off), and in the parity mode (sorted index_add_)
        torch.use_deterministic_algorithms(False)
        plain_ms = time_ms(lambda: k1.contract_plain(args[0], args[1], tuv,
                                                     out_rows), flush)
        torch.use_deterministic_algorithms(True)
        plain_det_ms = time_ms(
            lambda: k1.contract_plain(args[0], args[1], tuv, out_rows),
            flush)
        # inputs left in L2: the card first spins in place (no memory
        # traffic), so the launch is queued before the start event is
        # reached and the time is the kernel's, not the host's
        warm_ms = time_ms(lambda: k1.contract(role, *args),
                          lambda: torch.cuda._sleep(1_000_000))
        # host cost of one wrapper call: checks, ctypes call, enqueue
        sync()
        t0 = time.perf_counter()
        for _ in range(100):
            k1.contract(role, *args)
        host_us = (time.perf_counter() - t0) / 100 * 1e6
        sync()
        bound_ms, bound_by, nbytes, flops = k1_bound(tuv, out_rows, D)
        print(f"{role.NAME} timing (L2 flushed before each launch, median "
              f"of 30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(deterministic plain {plain_det_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} "
              f"f32 operations at 67 TFLOP/s); kernel with its inputs "
              f"left in L2 {warm_ms:.4f} ms; host time of one wrapper call "
              f"{host_us:.1f} us")
        report.append({"name": role.NAME, "route": "cuda",
                       "source": role.SOURCE, "replaces": role.REPLACES,
                       "launches": None, "max_abs_err": errs[role],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None})
    return report


def calibrate_batchnorm(model, predictor, datas):
    """Running statistics := the statistics of one batch, so that random
    weights give activations of order 1 in every layer."""
    import torch

    from pygho_tpu_torch.honn.utils import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    batch = next(iter(predictor._loader(datas)))
    with torch.no_grad():
        model(predictor._to_dict(batch))
    for bn, m in zip(bns, saved):
        bn.momentum = m
    model.eval()


def sparse_model(conv, device):
    """The sparse configuration ``SPARSE[conv]``, weights from seed 0."""
    from pygho_tpu_torch.models import make_sp_model

    return make_sp_model(conv, seed=0, device=device,
                         **copy.deepcopy(SPARSE[conv]))


def sparse_roles(conv):
    """The kernel roles that ``conv``'s layers launch (K1's or K4's)."""
    from pygho_tpu_torch.kernels import KERNELS

    return [mod for mod in KERNELS if mod.SOURCE.endswith(SPARSE_SOURCE[conv])]


def serve(graphs, rng, dev, conv="NGNN"):
    """``conv``-SS 6x128 through SpPredictor on ``dev``, then on the
    CPU."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata import KhopSampler
    from pygho_tpu_torch.honn import parse_precomputekey
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.models import SpPredictor

    model = sparse_model(conv, dev)
    keys = parse_precomputekey(model)
    if keys != [KEY]:
        raise AssertionError(f"unexpected precompute keys {keys}")
    sampler = partial(KhopSampler, hop=3)
    predictor = SpPredictor(model, sampler, keys, batch_size=128,
                            num_workers=0, device=dev)
    datas = predictor.preprocess(graphs)
    calibrate_batchnorm(model, predictor, datas)

    subset = [int(i) for i in rng.permutation(len(graphs))[:40]]
    requests = [graphs, [graphs[i] for i in subset], graphs]
    n_batches = sum(math.ceil(len(r) / predictor.batch_size)
                    for r in requests)
    # the main path: counts to 0 just before, read just after
    for mod in KERNELS:
        mod.launches = 0
    outs, walls = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(predictor(req))
        walls.append(time.perf_counter() - t0)
    launches = {mod.NAME: mod.launches for mod in KERNELS}
    print(f"served {[len(r) for r in requests]} graphs in {n_batches} "
          f"batches, {[f'{w:.3f}' for w in walls]} s; kernel launches "
          f"{launches}")
    expected = {mod.NAME: 0 for mod in KERNELS}
    expected[sparse_roles(conv)[0].NAME] = \
        SPARSE[conv]["num_layer"] * n_batches
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")

    full, part, again = outs
    for o, req in zip(outs, requests):
        if o.shape != (len(req), 1) or not np.isfinite(o).all():
            raise AssertionError(f"bad output {o.shape}, finite "
                                 f"{np.isfinite(o).all()}")
    rep = max(float(np.abs(again - full).max()),
              float(np.abs(part - full[subset]).max()))
    print(f"repeated graphs: max abs difference {rep:.3e} "
          f"(tolerance {REPEAT_TOL:g}); predictions range "
          f"[{full.min():.4f}, {full.max():.4f}]")
    if not rep <= REPEAT_TOL:
        raise AssertionError(f"repeated graphs differ by {rep}")

    cpu_model = copy.deepcopy(model).cpu()
    cpu = SpPredictor(cpu_model, sampler, keys, batch_size=128,
                      device="cpu")
    cpu_full, cpu_part = cpu(graphs), cpu([graphs[i] for i in subset])
    diff = max(float(np.abs(cpu_full - full).max()),
               float(np.abs(cpu_part - part).max()))
    print(f"card vs CPU (plain versions): max abs difference {diff:.3e} "
          f"(tolerance {SERVE_TOL:g})")
    if not diff <= SERVE_TOL:
        raise AssertionError(f"card and CPU disagree by {diff}")

    # throughput, after the checks: raw graphs (host precompute included)
    # and preprocessed graphs (collation, transfer and forward)
    sync()
    t0 = time.perf_counter()
    predictor(graphs)
    raw_s = time.perf_counter() - t0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor(datas)
    pre_s = (time.perf_counter() - t0) / reps
    breakdown(model, predictor, datas, dev)
    return len(graphs) / raw_s, len(graphs) / pre_s, launches


def breakdown(model, predictor, datas, dev, reps=5):
    """Where one batch's time goes: host collation, the copy to the card,
    and the forward (host wall time to its synchronised end, and device
    time between CUDA events)."""
    import torch

    def median_s(fn):
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    loader = predictor._loader(datas)
    loader.buckets = predictor._buckets
    collate_s = median_s(lambda: next(iter(loader)))
    batch = next(iter(loader))
    copy_s = median_s(lambda: predictor._to_dict(batch))
    dd = predictor._to_dict(batch)
    with torch.inference_mode():
        forward_s = median_s(lambda: model(dd))
        dev_ms = time_ms(lambda: model(dd), lambda: None, reps=reps,
                         warmup=1, settle=False) \
            if dev.type == "cuda" else 0.0
    print(f"one {predictor.batch_size}-graph batch (median of {reps}): "
          f"host collation {collate_s * 1e3:.3f} ms, copy to the card "
          f"{copy_s * 1e3:.3f} ms, forward {forward_s * 1e3:.3f} ms host "
          f"wall / {dev_ms:.3f} ms between CUDA events")


def train_run(device, batches, steps, per_step=None, conv="NGNN"):
    """``conv``-SS 6x128 from seed 0, ``steps`` AdamW steps at lr 1e-3 on
    ``batches`` through the port's ``make_sparse_steps``.  Returns the
    per-step losses and the model.  ``per_step(i)`` runs after each
    step."""
    from pygho_tpu_torch.models import make_optimizer, make_sparse_steps

    model = sparse_model(conv, device)
    model.train()
    opt = make_optimizer(model, TRAIN_LR)
    train_step, _ = make_sparse_steps()
    losses = []
    for i, batch in enumerate(batches[:steps]):
        losses.append(train_step(model, opt, batch))
        if per_step is not None:
            per_step(i)
    return [float(x) for x in losses], model


def training(card, dev, conv="NGNN"):
    """``conv``-SS 6x128 trains on the card: launch counts per step, finite
    losses, two runs bitwise identical, the CPU run's losses within
    TRAIN_RTOL; then graphs/s trained, a per-step breakdown and the peak
    device memory.  Returns the launches of the first training run."""
    import torch

    from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                        Sppretransform, synthetic_zinc)
    from pygho_tpu_torch.kernels import KERNELS

    t0 = time.perf_counter()
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in synthetic_zinc("train", seed=SEED)]
    loader = SpDataloader(datas, 128, [KEY], shuffle=True, drop_last=True,
                          seed=0, backward=True)
    batches = []
    while len(batches) < TRAIN_STEPS:      # 8 batches an epoch
        batches.extend(loader)
    batches = batches[:TRAIN_STEPS]
    print(f"training data: {len(datas)} graphs of synthetic_zinc(\"train\")"
          f", {TRAIN_STEPS} shuffled batches of 128 (loader seed 0), "
          f"preprocessed and collated in {time.perf_counter() - t0:.3f} s")

    # the main path: counts to 0 just before, read after every step
    counts = []

    def read(_):
        counts.append({mod.NAME: mod.launches for mod in KERNELS})

    sync()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS:
        mod.launches = 0
    t0 = time.perf_counter()
    losses, model = train_run(dev, batches, TRAIN_STEPS, read, conv)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"trained {TRAIN_STEPS} steps in {run_s:.3f} s; losses "
          f"{[f'{x:.6f}' for x in losses]}; kernel launches {launches}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB ({peak} bytes)")
    mine = {mod.NAME for mod in sparse_roles(conv)}
    want = {mod.NAME: SPARSE[conv]["num_layer"] if mod.NAME in mine else 0
            for mod in KERNELS}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    again, model2 = train_run(dev, batches, TRAIN_STEPS, conv=conv)
    state, state2 = model.state_dict(), model2.state_dict()
    same = again == losses and all(torch.equal(state[k], state2[k])
                                   for k in state)
    print(f"second run from the same seed: losses and all {len(state)} "
          f"parameters and buffers bitwise identical: {same}")
    if not same:
        raise AssertionError(f"two runs differ: {losses} vs {again}")
    del model, model2, state, state2

    cpu_steps = CPU_STEPS if conv == "NGNN" else NGAT_CPU_STEPS
    t0 = time.perf_counter()
    cpu_losses, _ = train_run("cpu", batches, cpu_steps, conv=conv)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"card vs CPU (plain versions), the first {cpu_steps} steps in "
          f"{time.perf_counter() - t0:.3f} s on the CPU: max relative loss "
          f"difference {rel:.3e} (tolerance {TRAIN_RTOL:g}); CPU losses "
          f"{[f'{x:.6f}' for x in cpu_losses]}")
    if not rel <= TRAIN_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")

    train_timing(card, dev, datas, conv=conv)
    print(f"{conv}-SS 6x128 training: peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes) over the first run")
    return launches


def train_timing(card, dev, datas, reps=8, conv="NGNN"):
    """Prints graphs/s trained over one epoch of the loader (collation
    included, one sync at the end), then one step's breakdown: host
    collation, the copy to the card, forward+backward and the optimizer
    step (each synchronised; medians over ``reps`` steps), forward+backward
    between CUDA events, and a whole step between CUDA events."""
    from pygho_tpu_torch.hodata import SpDataloader
    from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
    from pygho_tpu_torch.models import (make_optimizer, make_sparse_steps,
                                        masked_l1_loss)

    model = sparse_model(conv, dev)
    model.train()
    opt = make_optimizer(model, TRAIN_LR)
    train_step, _ = make_sparse_steps()
    loader = SpDataloader(datas, 128, [KEY], shuffle=True, drop_last=True,
                          seed=1, backward=True)
    for batch in loader:                  # warm up: buckets, allocator
        train_step(model, opt, batch)
    sync()
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        train_step(model, opt, batch)
        n += 128
    sync()
    gps = n / (time.perf_counter() - t0)

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    parts = {"collation": [], "copy": [], "fwd+bwd": [], "optimizer": []}
    it = iter(loader)
    for _ in range(reps):
        batch, s = timed(lambda: next(it))
        parts["collation"].append(s)
        dd, s = timed(lambda: batch_to_sparse_dict(batch, ("",), dev))
        parts["copy"].append(s)

        def fwd_bwd():
            loss = masked_l1_loss(model(dd), dd["y"], dd["graph_mask"])
            opt.zero_grad(set_to_none=True)
            loss.backward()

        _, s = timed(fwd_bwd)
        parts["fwd+bwd"].append(s)
        _, s = timed(opt.step)
        parts["optimizer"].append(s)
    dev_ms = time_ms(fwd_bwd, lambda: None, reps=reps, warmup=1,
                     settle=False)
    step_ms = time_ms(lambda: train_step(model, opt, batch), lambda: None,
                      reps=reps, warmup=1, settle=False)
    med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    print(f"{conv}-SS 6x128 training on {card}: {gps:.1f} graphs/s trained "
          f"(one epoch of 8 steps, collation included)")
    print(f"one 128-graph training step (median of {reps}): host "
          f"collation {med['collation']:.3f} ms, copy to the card "
          f"{med['copy']:.3f} ms, forward+backward {med['fwd+bwd']:.3f} ms "
          f"host wall / {dev_ms:.3f} ms between CUDA events, optimizer "
          f"{med['optimizer']:.3f} ms; sum {sum(med.values()):.3f} ms; a "
          f"whole step on a collated batch (copy included) {step_ms:.3f} ms "
          f"between CUDA events")


def k5_bound(shape):
    """The least time of one K5 role on the card: its two operands read
    once and its output written once, against its 2 * b * n^3 * d f32
    operations.  Returns (ms, "bytes" or "operations", bytes,
    operations)."""
    b, n, _, d = shape
    nbytes = 3 * b * n * n * d * 4
    flops = 2 * b * n ** 3 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def check_k5(datas, dev, rng, flush):
    """K5's three roles at the dense path's shape and on edge cases,
    against their plain version on the card; the four ``mamamm`` dim
    variants; and ``ChannelwiseBmm``'s gradients against autograd through
    the plain version.  Returns the roles' lines of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.backend.mamamm import mamamm
    from pygho_tpu_torch.backend.matensor import MaskedTensor
    from pygho_tpu_torch.hodata import MaDataloader
    from pygho_tpu_torch.kernels import channelwise_bmm as k5

    batch = next(iter(MaDataloader(datas, 128)))
    mask = torch.from_numpy(batch["X_mask"]).to(dev)
    shape = tuple(mask.shape) + (DENSE["hiddim"],)

    def operand(shape, mask=None):
        """Normal values, zero off ``mask`` as ``mamamm`` fills them."""
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev)
        return x if mask is None else torch.where(mask[..., None], x, 0.0)

    def role_args(A, X, g):
        """Each role's operands as ``ChannelwiseBmm`` passes them, the
        transposes as strided views: forward (A, X), dA (g, X^T), dX
        (A^T, g)."""
        return {k5.FWD: (A, X), k5.DA: (g, X.transpose(1, 2)),
                k5.DX: (A.transpose(1, 2), g)}

    def compare(role, A, X):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance K5_RTOL * sum |terms|, bitwise equal)."""
        out = k5.cw_bmm(role, A, X)
        ref = k5.cw_bmm_plain(A, X)
        mag = k5.cw_bmm_plain(A.abs(), X.abs())
        sync()
        if tuple(out.shape) != tuple(A.shape) or not out.is_contiguous():
            raise AssertionError(f"{role.NAME} gave {tuple(out.shape)}")
        return measure(out, ref, mag)

    def measure(out, ref, mag):
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (K5_RTOL * mag).clamp_min(1e-30)).max()),
                bool(torch.equal(out, ref)))

    def held(what, err, ratio, same):
        print(f"{what}: max abs err {err:.3e}, {ratio:.3f} of the tolerance "
              f"{K5_RTOL:g} * sum |terms|; bitwise equal to the plain "
              f"version: {same}")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    A, X, g = (operand(shape, mask) for _ in range(3))
    main = role_args(A, X, g)
    errs = {}
    for role, args in main.items():
        errs[role], ratio, same = compare(role, *args)
        held(f"{role.NAME} main shape {shape}", errs[role], ratio, same)

    # edge cases, for every role: n = 1; n (37, 33) not a multiple of the
    # 32 x 32 tile of (i, j) or of the 4 values of k a stage; d (13, 200)
    # not a multiple of the 16 channels of a block (d = 13 also not of the
    # 4 of a 16-byte copy: the scalar path); a batch whose first graph is
    # all masked
    for name, shp in (("n=1", (4, 1, 1, 128)),
                      ("n=37", (3, 37, 37, 128)),
                      ("d=13", (5, 20, 20, 13)),
                      ("n=33, d=200", (2, 33, 33, 200))):
        case = role_args(*(operand(shp) for _ in range(3)))
        for role, args in case.items():
            held(f"{role.NAME} edge case {name} {shp}", *compare(role, *args))
    empty = mask[:6].clone()
    empty[0] = False
    case = role_args(*(operand(tuple(empty.shape) + (128,), empty)
                       for _ in range(3)))
    for role, args in case.items():
        held(f"{role.NAME} edge case all-masked graph", *compare(role, *args))
        if bool((k5.cw_bmm(role, *args)[0] != 0).any()):
            raise AssertionError(f"{role.NAME}: an all-masked graph gave a "
                                 f"non-zero output")

    # mamamm's four (dim1, dim2) variants, each brought to the kernel's
    # (2, 1) contraction through strided views
    ma = MaskedTensor(operand(tuple(empty.shape) + (128,)), empty)
    mb = MaskedTensor(operand(tuple(empty.shape) + (128,)), mask[6:12])
    for dim1, dim2 in ((2, 1), (1, 1), (2, 2), (1, 2)):
        with torch.no_grad():
            out = mamamm(ma, dim1, mb, dim2, empty).data
            fa, fb = ma.fill_masked(0.0), mb.fill_masked(0.0)
            fa = fa if dim1 == 2 else fa.transpose(1, 2)
            fb = fb if dim2 == 1 else fb.transpose(1, 2)
            ref = k5.cw_bmm_plain(fa, fb)
            mag = k5.cw_bmm_plain(fa.abs(), fb.abs())
        held(f"mamamm (dim1, dim2) = ({dim1}, {dim2}) through "
             f"{k5.FWD.NAME}", *measure(out, ref, mag))

    # ChannelwiseBmm's gradients against autograd through the plain version
    W = operand(shape, mask)
    Ak, Xk = A.clone().requires_grad_(), X.clone().requires_grad_()
    (k5.ChannelwiseBmm.apply(Ak, Xk) * W).sum().backward()
    Ap, Xp = A.clone().requires_grad_(), X.clone().requires_grad_()
    (k5.cw_bmm_plain(Ap, Xp) * W).sum().backward()
    with torch.no_grad():
        mags = (k5.cw_bmm_plain(W.abs(), X.abs().transpose(1, 2)),
                k5.cw_bmm_plain(A.abs().transpose(1, 2), W.abs()))
    for what, got, ref, mag in (("grad_A", Ak.grad, Ap.grad, mags[0]),
                                ("grad_X", Xk.grad, Xp.grad, mags[1])):
        held(f"ChannelwiseBmm {what} vs autograd through the plain version",
             *measure(got, ref, mag))
    del Ak, Xk, Ap, Xp, W, mags

    report = []
    bound_ms, bound_by, nbytes, flops = k5_bound(shape)
    for role, args in main.items():
        ms = time_ms(lambda: k5.cw_bmm(role, *args), flush)
        plain_ms = time_ms(lambda: k5.cw_bmm_plain(*args), flush)
        # the library's call for the same function on the same inputs, f32
        # without TF32 (set_parity_numerics)
        lib_ms = time_ms(lambda: torch.einsum("bikd,bkjd->bijd", *args),
                         flush)
        warm_ms = time_ms(lambda: k5.cw_bmm(role, *args),
                          lambda: torch.cuda._sleep(1_000_000))
        print(f"{role.NAME} timing (L2 flushed before each launch, median "
              f"of 30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.einsum {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s, {flops} f32 operations at 67 "
              f"TFLOP/s); kernel with its inputs left in L2 {warm_ms:.4f} ms")
        report.append({"name": role.NAME, "route": "cuda",
                       "source": role.SOURCE, "replaces": role.REPLACES,
                       "launches": None, "max_abs_err": errs[role],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms})
    return report


def k4_terms(role, ops, tuv, rows, M, gZ, goZ):
    """Each output of one K4 role's sum of |terms|, the scale of its
    rounding: the forward's out Σ α |a3[c]| (α = e / den), den itself
    and |M|; the gradient roles' sums of |ds| times their two factors,
    with |ds| <= e (|a3[c] gZ[a]| + |goZ[a]|), and dc's Σ e |gZ[a]|."""
    import torch

    from pygho_tpu_torch.kernels import segment_attention as k4

    a1, a3, aA, a2 = ops
    if role is k4.FWD:
        out_abs, den, M = k4.attention_plain(k4.FWD, a1, a3.abs(), aA, a2,
                                             tuv, rows)
        return out_abs, den, M.abs()
    idx = tuv.long()
    a, c, d = (idx[i] for i in k4.ACD_POSITIONS[role])

    def ssum(x):
        return torch.zeros(rows, x.shape[1], device=x.device) \
            .index_add_(0, idx[0], x)

    e = torch.exp((a1[c] * aA[d]) * a2[a] - M[a])
    ads = e * (a3[c].abs() * gZ[a].abs() + goZ[a].abs())
    if role is k4.DW:
        return (ssum(ads * a1[c].abs() * aA[d].abs()),)
    if role is k4.DC:
        return (ssum(ads * aA[d].abs() * a2[a].abs()),
                ssum(e * gZ[a].abs()))
    return (ssum(ads * a1[c].abs() * a2[a].abs()),)


def k4_bound(role, tuv, rowptr, D):
    """The least time of one K4 role on the card: every referenced row of
    each operand it reads once (forward: a2 by t, a1 and a3 by u, aA by v;
    dw: a2, M, gZ, goZ by t, a1 and a3 by u, aA by v; dc: a1 and a3 by t,
    a2, M, gZ, goZ by u, aA by v; dv: aA by t, a1 and a3 by u, a2, M, gZ,
    goZ by v), its index arrays and row pointer once, and every output
    written once, against its f32 operations (an exp counted as one):
    per triple and channel 8 in the forward (and a division per output),
    10 in dw and dv, 12 in dc.  Returns (ms, "bytes" or "operations",
    bytes, operations)."""
    import torch

    from pygho_tpu_torch.kernels import segment_attention as k4

    k = tuv.shape[1]
    out_rows = rowptr.shape[0] - 1
    t_read = int((rowptr[1:] > rowptr[:-1]).sum())
    u_read = int(torch.unique(tuv[1]).numel())
    v_read = int(torch.unique(tuv[2]).numel())
    per_t, per_u, per_v, n_out, ops = {
        k4.FWD: (1, 2, 1, 3, 8), k4.DW: (4, 2, 1, 1, 10),
        k4.DC: (2, 4, 1, 2, 12), k4.DV: (1, 2, 4, 1, 10)}[role]
    rows = t_read * per_t + u_read * per_u + v_read * per_v \
        + out_rows * n_out
    nbytes = rows * D * 4 + k * 2 * 4 + (out_rows + 1) * 4
    flops = ops * k * D + (out_rows * D if role is k4.FWD else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def check_k4(datas, dev, rng, flush):
    """K4's four roles at the NGAT path's shapes and on edge cases, against
    their plain version on the card, and ``SegmentAttention``'s gradients
    against autograd through the plain forward.  Returns the roles' lines
    of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata.loader import (SpDataloader,
                                               backward_orders, row_pointer)
    from pygho_tpu_torch.kernels import segment_attention as k4

    batch = next(iter(SpDataloader(datas, 128, [KEY], backward=True)))
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    n_t, n_e = int(batch["num_tuples"]), int(batch["num_edges"])
    D = 128

    def operand(rows, real, scale=1.0):
        x = np.zeros((rows, D), np.float32)
        x[:real] = scale * rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    def grad_inputs(ops, tuv, rowptr, g):
        """M from the plain forward, and gZ, goZ for the cotangent g, as
        ``SegmentAttention.backward`` forms them."""
        out, den, M = k4.attention_plain(k4.FWD, *ops, tuv,
                                         rowptr.shape[0] - 1)
        return (M, *k4.softmax_cotangents(g, out, den))

    def compare(role, ops, tuv, rowptr, M=None, gZ=None, goZ=None):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance), over every output of the role; raises on a value that
        is not finite, or where the kernel's bits differ from the plain
        version's (the same rounded steps, each row summed in triple
        order)."""
        rows = rowptr.shape[0] - 1
        got = k4.attend(role, *ops, tuv, rowptr, M, gZ, goZ)
        ref = k4.attention_plain(role, *ops, tuv, rows, M, gZ, goZ)
        mags = k4_terms(role, ops, tuv, rows, M, gZ, goZ)
        sync()
        err = ratio = 0.0
        for x, r, mag in zip(got, ref, mags):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{role.NAME} gave a value that is "
                                     f"not finite")
            if x.numel() == 0:
                continue
            if not torch.equal(x, r):
                raise AssertionError(f"{role.NAME} is not bit for bit equal "
                                     f"to its plain version")
            diff = (x - r).abs()
            err = max(err, float(diff.max()))
            ratio = max(ratio, float(
                (diff / (ATT_RTOL * mag).clamp_min(1e-30)).max()))
        return err, ratio

    def held(what, err, ratio, bitwise=False):
        print(f"{what}: {'bit for bit equal, ' if bitwise else ''}max abs "
              f"err {err:.3e}, {ratio:.3f} of the tolerance {ATT_RTOL:g} * "
              f"sum |terms|")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    ops = (operand(nt, n_t), operand(nt, n_t), operand(ne, n_e),
           operand(nt, n_t))
    t = {name: torch.from_numpy(batch[f"{KEY}___{name}"]).to(dev)
         for name in ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da",
                      "rowptr_da")}
    grads = grad_inputs(ops, t["acd"], t["rowptr"], operand(nt, n_t))
    main = {k4.FWD: (t["acd"], t["rowptr"]),
            k4.DW: (t["acd"], t["rowptr"], *grads),
            k4.DC: (t["acd_dx"], t["rowptr_dx"], *grads),
            k4.DV: (t["acd_da"], t["rowptr_da"], *grads)}
    errs = {}
    for role, args in main.items():
        errs[role], ratio = compare(role, ops, *args)
        held(f"{role.NAME} main shape: {args[0].shape[1]} triples, a1 "
             f"{tuple(ops[0].shape)}, aA {tuple(ops[2].shape)}, out rows "
             f"{args[1].shape[0] - 1}", errs[role], ratio, True)

    # edge cases, for every role: empty rows, a row of one triple and one
    # of 2,000 (its backward orders spread it over many rows); D = 13 and
    # an a1 one float off 16-byte alignment (both take the scalar loop);
    # scores scaled 3x, where the TPU kernel's bound shift flushes; and
    # short rows with a run of 130 empty rows mid-array, rows of 9, 33 and
    # 120 triples over several chunks (the forward walks them twice) and 5
    # triples past a multiple of 32 (every chunk size)
    x_rows, e_rows = 600, 400
    rows = np.concatenate([np.full(2000, 5), rng.integers(0, 590, 3000),
                           [599]])
    heavy = np.sort(rows[(rows != 3) & (rows != 17)])
    lens = rng.integers(0, 6, x_rows)
    lens[300:430] = 0
    lens[[7, 8, 9, 10]] = (120, 33, 32, 9)
    lens[-1] += (5 - lens.sum()) % 32
    runs = np.repeat(np.arange(x_rows), lens)
    for name, a, Dc, scale, misalign in (
            ("empty rows, one-triple and 2,000-triple rows, D=128", heavy,
             128, 1.0, False),
            ("D=13 (scalar loop)", heavy, 13, 1.0, False),
            ("a1 off 16-byte alignment (scalar loop)", heavy, 128, 1.0,
             True),
            ("scores scaled 3x", heavy, 128, 3.0, False),
            ("short rows, 130 empty rows mid-array, rows over several "
             "chunks, k = 5 mod 32, D=128", runs, 128, 1.0, False)):
        acd = np.stack([a, rng.integers(0, x_rows, a.size),
                        rng.integers(0, e_rows, a.size)])
        orders = {r: [torch.from_numpy(x).to(dev) for x in v]
                  for r, v in backward_orders(acd, x_rows, e_rows).items()}
        e_acd = torch.from_numpy(acd.astype(np.int32)).to(dev)
        e_rp = torch.from_numpy(row_pointer(a, x_rows)).to(dev)
        eops = [torch.from_numpy((scale * rng.normal(size=(n, Dc)))
                                 .astype(np.float32)).to(dev)
                for n in (x_rows, x_rows, e_rows, x_rows)]
        if misalign:
            flat = torch.empty(x_rows * Dc + 1, device=dev)[1:]
            eops[0] = flat.view(x_rows, Dc).copy_(eops[0])
        g = torch.from_numpy(rng.normal(size=(x_rows, Dc))
                             .astype(np.float32)).to(dev)
        egrads = grad_inputs(eops, e_acd, e_rp, g)
        cases = {k4.FWD: (e_acd, e_rp), k4.DW: (e_acd, e_rp, *egrads),
                 k4.DC: (*orders["dx"], *egrads),
                 k4.DV: (*orders["da"], *egrads)}
        for role, args in cases.items():
            held(f"{role.NAME} edge case {name}",
                 *compare(role, eops, *args), True)
        if scale != 1.0:
            # where the TPU kernel's shift |a2[a]| max|a1| max|aA| lies
            # more than 60 nats above the row's maximum, its denominator
            # falls under its floor and the entry comes out 0
            M = egrads[0]
            over = eops[3].abs() * (eops[0].abs().amax(0)
                                    * eops[2].abs().amax(0)) - M
            live = (e_rp[1:] > e_rp[:-1])[:, None].expand_as(M)
            print(f"  scaled 3x: {int((over[live] > 60).sum())} of "
                  f"{int(live.sum())} live (row, channel) entries lie more "
                  f"than 60 nats under the TPU kernel's shift; every "
                  f"output here is finite")

    # SegmentAttention's gradients on the card against autograd through the
    # plain forward, for a random cotangent W
    W = operand(nt, n_t)
    bwd = (t["acd_dx"], t["rowptr_dx"], t["acd_da"], t["rowptr_da"])
    ks = [x.clone().requires_grad_() for x in ops]
    (k4.SegmentAttention.apply(*ks, t["acd"], t["rowptr"], bwd) * W) \
        .sum().backward()
    ps = [x.clone().requires_grad_() for x in ops]
    (k4.attention_plain(k4.FWD, *ps, t["acd"], nt)[0] * W).sum().backward()
    with torch.no_grad():
        wgrads = grad_inputs(ops, t["acd"], t["rowptr"], W)
        dc = k4_terms(k4.DC, ops, t["acd_dx"], nt, *wgrads)
        mags = {"grad_a1": dc[0], "grad_a3": dc[1],
                "grad_aA": k4_terms(k4.DV, ops, t["acd_da"], ne, *wgrads)[0],
                "grad_a2": k4_terms(k4.DW, ops, t["acd"], nt, *wgrads)[0]}
    for (what, mag), got, ref in zip(mags.items(), ks, ps):
        diff = (got.grad - ref.grad).abs()
        held(f"SegmentAttention {what} vs autograd through the plain "
             f"forward", float(diff.max()),
             float((diff / (ATT_RTOL * mag).clamp_min(1e-30)).max()))
    del ks, ps, W, mags, dc

    report = []
    for role, args in main.items():
        tuv, rowptr = args[0], args[1]
        ms = time_ms(lambda: k4.attend(role, *ops, *args), flush)
        plain_ms = time_ms(lambda: k4.attention_plain(
            role, *ops, tuv, rowptr.shape[0] - 1, *args[2:]), flush)
        warm_ms = time_ms(lambda: k4.attend(role, *ops, *args),
                          lambda: torch.cuda._sleep(1_000_000))
        bound_ms, bound_by, nbytes, flops = k4_bound(role, tuv, rowptr, D)
        print(f"{role.NAME} timing (L2 flushed before each launch, median "
              f"of 30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} f32 "
              f"operations at 67 TFLOP/s); kernel with its inputs left in "
              f"L2 {warm_ms:.4f} ms")
        report.append({"name": role.NAME, "route": "cuda",
                       "source": role.SOURCE, "replaces": role.REPLACES,
                       "launches": None, "max_abs_err": errs[role],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None})
    return report


def giant_instance():
    """The giant graph of ``example/giant_graph_gpu.py`` at GIANT's size,
    as numpy arrays (graph, tuples, triples, inputs from one seed)."""
    sys.path.insert(0, str(REPO / "example"))
    from giant_graph_gpu import giant_instance as build

    return build(GIANT["communities"], GIANT["csize"], GIANT["hiddim"])


def check_k3(inst, dev, rng, flush):
    """K3's three roles at the giant graph's shapes (hop-1 triples of the
    RCM-ordered 200x100 community graph, D = 128) and on edge cases,
    against their plain version on the card; ``WindowSpspmmSum``'s
    gradients, with both operands requiring grad, against autograd through
    the plain version; and the roles' times beside K1's three roles on the
    same triples and row pointers.  Returns the roles' lines of the
    report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.kernels import window_spspmm as k3

    acd, nnz, ne = inst["acd"], inst["nnz_pad"], inst["Av"].shape[0]
    n_t = inst["tup"].shape[1]
    D = GIANT["hiddim"]
    t0 = time.perf_counter()
    host = k3.build_chunk_plans(acd, nnz, ne, nnz)
    plan_s = time.perf_counter() - t0
    plans = [p.to(dev) for p in host]
    print(f"K3 plans of the giant graph ({acd.shape[1]} triples, {nnz} tuple "
          f"rows, {ne} edge rows) built in {plan_s:.3f} s on the host: "
          + "; ".join(f"{r.NAME}: {p.n_warps} warps over {p.out_rows} rows "
                      f"({int(np.count_nonzero(np.diff(p.rowptr)))} with "
                      f"triples)" for r, p in zip(k3.ROLES, host)))

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    X, A, g = operand(nnz, n_t), operand(ne, ne), operand(nnz, n_t)
    main = {k3.FWD: (X, A, plans[0]), k3.DX: (g, A, plans[1]),
            k3.DA: (X, g, plans[2])}

    def compare(role, U, V, plan):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance, bitwise equal); raises where a row with no triples is
        not 0."""
        out = k3.contract(role, U, V, plan)
        ref = k1.contract_plain(U, V, plan.tuv, plan.out_rows)
        mag = k1.contract_plain(U.abs(), V.abs(), plan.tuv, plan.out_rows)
        sync()
        if out.numel() == 0:
            return 0.0, 0.0, True
        empty = torch.bincount(plan.tuv[0].long(),
                               minlength=plan.out_rows) == 0
        if bool((out[empty] != 0).any()):
            raise AssertionError(f"{role.NAME} wrote a non-zero empty row")
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()),
                bool(torch.equal(out, ref)))

    def held(what, err, ratio, same):
        print(f"{what}: max abs err {err:.3e}, {ratio:.3f} of the tolerance "
              f"{KERNEL_RTOL:g} * sum |terms|; bitwise equal to the plain "
              f"version: {same}")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    errs = {}
    for role, args in main.items():
        errs[role], ratio, same = compare(role, *args)
        held(f"{role.NAME} giant shape ({args[2].tuv.shape[1]} triples, "
             f"out {(args[2].out_rows, D)})", errs[role], ratio, same)

    # edge cases, for every role: short rows (0 to 5 triples) with empty
    # rows among them and a run of 61 empty rows (two warps and more), a
    # 120-triple row over five chunks, a row whose first triple starts a
    # chunk, D = 13 and D = 40 (scalar lanes, a partial last pass), both
    # operands one float off 16-byte alignment (the scalar path at D =
    # 128), and no triples
    lens = rng.integers(0, 6, 300)
    lens[[3, 150]] = 0
    lens[200:261] = 0
    lens[7] = 120
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    r = 20 + int(np.argmax((starts[20:] % k3.CHUNK_TRIPLES != 0)
                           & (lens[20:] > 0)))
    lens[r - 1] += k3.CHUNK_TRIPLES - starts[r] % k3.CHUNK_TRIPLES
    t_ = np.repeat(np.arange(300), lens)
    tuv = np.stack([t_, rng.integers(0, 400, t_.size),
                    rng.integers(0, 2000, t_.size)])
    cases = {
        "short and empty rows, a 120-triple row, a row at a chunk start, "
        "D=128": (128, tuv, 300, 2000, False),
        "D=13": (13, tuv, 300, 2000, False),
        "D=40": (40, tuv, 300, 2000, False),
        "operands one float off alignment, D=128": (128, tuv, 300, 2000,
                                                    True),
        "no triples": (128, np.zeros((3, 0), np.int64), 10, 10, False),
    }

    def case_operand(rows, Dc, offset):
        x = torch.from_numpy(rng.normal(size=rows * Dc + 1)
                             .astype(np.float32)).to(dev)
        return (x[1:] if offset else x[:-1]).view(rows, Dc)

    for role in k3.ROLES:
        for name, (Dc, tuv_c, o_rows, v_rows, offset) in cases.items():
            plan = k3.build_chunk_plan(tuv_c, o_rows, 400, v_rows)
            Uc = case_operand(400, Dc, offset)
            Vc = case_operand(v_rows, Dc, offset)
            held(f"{role.NAME} edge case {name} ({plan.n_warps} warps)",
                 *compare(role, Uc, Vc, plan.to(dev)))

    # WindowSpspmmSum's gradients against autograd through the plain
    # version, both operands requiring grad (so the dA role runs)
    W = operand(nnz, n_t)
    for mod in k3.ROLES:
        mod.launches = 0
    Xk, Ak = X.clone().requires_grad_(), A.clone().requires_grad_()
    (k3.WindowSpspmmSum.apply(Xk, Ak, plans) * W).sum().backward()
    ran = {mod.NAME: mod.launches for mod in k3.ROLES}
    if set(ran.values()) != {1}:
        raise AssertionError(f"WindowSpspmmSum launched {ran}")
    Xp, Ap = X.clone().requires_grad_(), A.clone().requires_grad_()
    (k1.contract_plain(Xp, Ap, plans[0].tuv, nnz) * W).sum().backward()
    with torch.no_grad():
        mags = (k1.contract_plain(W.abs(), A.abs(), plans[1].tuv, nnz),
                k1.contract_plain(X.abs(), W.abs(), plans[2].tuv, ne))
    for what, got, ref, mag in (("grad_X", Xk.grad, Xp.grad, mags[0]),
                                ("grad_A", Ak.grad, Ap.grad, mags[1])):
        diff = (got - ref).abs()
        held(f"WindowSpspmmSum {what} vs autograd through the plain version",
             float(diff.max()),
             float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()),
             bool(torch.equal(got, ref)))

    # K1's three roles on the same triples and row pointers: the yardstick
    report, k1_lines = [], []
    for role, r1 in zip(k3.ROLES, k1.ROLES):
        U, V, plan = main[role]
        k1_args = (U, V, plan.tuv, plan.rowptr)
        k1_out = k1.contract(r1, *k1_args)
        k1_same = bool(torch.equal(k1_out, k3.contract(role, U, V, plan)))
        ms = time_ms(lambda: k3.contract(role, U, V, plan), flush)
        k1_ms = time_ms(lambda: k1.contract(r1, *k1_args), flush)
        torch.use_deterministic_algorithms(False)
        plain_ms = time_ms(lambda: k1.contract_plain(U, V, plan.tuv,
                                                     plan.out_rows), flush)
        torch.use_deterministic_algorithms(True)
        warm_ms = time_ms(lambda: k3.contract(role, U, V, plan),
                          lambda: torch.cuda._sleep(1_000_000))
        k1_warm_ms = time_ms(lambda: k1.contract(r1, *k1_args),
                             lambda: torch.cuda._sleep(1_000_000))
        bound_ms, bound_by, nbytes, flops = k1_bound(plan.tuv,
                                                     plan.out_rows, D)
        print(f"{role.NAME} timing at the giant shape (L2 flushed before "
              f"each launch, median of 30): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; K1 {r1.NAME} on the same triples "
              f"{k1_ms:.4f} ms (bitwise equal to K3: {k1_same}); bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} f32 "
              f"operations at 67 TFLOP/s); inputs left in L2: K3 "
              f"{warm_ms:.4f} ms, K1 {k1_warm_ms:.4f} ms")
        k1_lines.append({"name": r1.NAME, "ms": k1_ms, "warm_ms": k1_warm_ms,
                         "k3": role.NAME, "k3_ms": ms, "k3_warm_ms": warm_ms,
                         "bound_ms": bound_ms, "bitwise": k1_same})
        report.append({"name": role.NAME, "route": "cuda",
                       "source": role.SOURCE, "replaces": role.REPLACES,
                       "launches": None, "max_abs_err": errs[role],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"k1_at_giant_shapes": k1_lines}))
    return report


def giant_train_run(device, inst, plan, steps, per_step=None):
    """The giant stack from seed 0, ``steps`` SGD steps on ``device``.
    Returns the per-step losses and the model."""
    import torch

    from pygho_tpu_torch.parallel import (init_giant_params,
                                          make_giant_graph_step)

    model = init_giant_params(GIANT["num_layer"], GIANT["hiddim"], seed=0,
                              device=device)
    _, step = make_giant_graph_step(plan, GIANT["num_layer"],
                                    lr=GIANT["lr"], device=device)
    Xv, Av, y = (torch.from_numpy(inst[k]).to(device)
                 for k in ("Xv", "Av", "y"))
    losses = []
    for i in range(steps):
        losses.append(step(model, Xv, Av, y))
        if per_step is not None:
            per_step(i)
    return [float(x) for x in losses], model, (step, Xv, Av, y)


def train_giant(card, dev, inst):
    """The giant graph trains on the card through ``parallel/giant.py``:
    three K3 forward and three dX launches a step and nothing else, finite
    losses, two runs bitwise identical, the CPU's losses within
    GIANT_RTOL; then ms a step, the plan's host time and the peak device
    memory.  Returns the launches of the first run."""
    import torch

    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.kernels import window_spspmm as k3
    from pygho_tpu_torch.parallel import build_giant_graph_plan

    t0 = time.perf_counter()
    plan = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                  inst["nnz_pad"], inst["n"], 1,
                                  n_edge_rows=inst["Av"].shape[0],
                                  plan_dim=GIANT["hiddim"])
    plan_s = time.perf_counter() - t0
    print(f"giant graph: {inst['n']} nodes, {inst['edge_index'].shape[1]} "
          f"edges, {inst['tup'].shape[1]} tuples (padded to "
          f"{inst['nnz_pad']}), {inst['acd'].shape[1]} triples; plan built in "
          f"{plan_s:.3f} s on the host")

    counts = []

    def read(_):
        counts.append({mod.NAME: mod.launches for mod in KERNELS})

    sync()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS:
        mod.launches = 0
    t0 = time.perf_counter()
    losses, model, (step, Xv, Av, y) = giant_train_run(
        dev, inst, plan, GIANT_STEPS, read)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"trained {GIANT_STEPS} steps in {run_s:.3f} s (the first "
          f"includes moving the plan); losses {[f'{x:.7f}' for x in losses]}; "
          f"kernel launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes)")
    want = {mod.NAME: 0 for mod in KERNELS}
    want[k3.FWD.NAME] = want[k3.DX.NAME] = GIANT["num_layer"]
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    again, model2, _ = giant_train_run(dev, inst, plan, GIANT_STEPS)
    same = again == losses and all(
        torch.equal(p, q) for p, q in zip(model.parameters(),
                                          model2.parameters()))
    print(f"second run from the same seed: losses and all "
          f"{len(list(model.parameters()))} parameters bitwise identical: "
          f"{same}")
    if not same:
        raise AssertionError(f"two runs differ: {losses} vs {again}")
    del model2
    # a step's time, on the first run's model (its steps go on training it)
    step_ms = time_ms(lambda: step(model, Xv, Av, y), lambda: None,
                      reps=10, warmup=2, settle=False)
    del model

    t0 = time.perf_counter()
    cpu_losses, _, _ = giant_train_run("cpu", inst, plan, GIANT_CPU_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"card vs CPU (plain versions), the first {GIANT_CPU_STEPS} steps "
          f"in {time.perf_counter() - t0:.3f} s on the CPU: max relative "
          f"loss difference {rel:.3e} (tolerance {GIANT_RTOL:g}); CPU losses "
          f"{[f'{x:.7f}' for x in cpu_losses]}")
    if not rel <= GIANT_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")
    print(f"giant graph {GIANT['communities']}x{GIANT['csize']}, hiddim "
          f"{GIANT['hiddim']}, {GIANT['num_layer']} layers on {card}: "
          f"{step_ms:.3f} ms a step between CUDA events (median of 10); "
          f"plan {plan_s:.3f} s on the host; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    return launches


def dense_model(device):
    """PPGN-DD as DENSE configures it, weights from seed 0."""
    from pygho_tpu_torch.models import make_ma_model

    return make_ma_model("PPGN", seed=0, device=device, **DENSE)


def serve_dense(graphs, rng, dev):
    """PPGN-DD 6x128 through MaPredictor on ``dev``, then on the CPU."""
    import numpy as np

    from pygho_tpu_torch.hodata import spdsampler
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.kernels import channelwise_bmm as k5
    from pygho_tpu_torch.models import MaPredictor

    model = dense_model(dev)
    sampler = partial(spdsampler, hop=DENSE_HOP)
    predictor = MaPredictor(model, sampler, batch_size=128, device=dev)
    datas = predictor.preprocess(graphs)
    calibrate_batchnorm(model, predictor, datas)

    subset = [int(i) for i in rng.permutation(len(graphs))[:40]]
    requests = [graphs, [graphs[i] for i in subset], graphs]
    n_batches = sum(math.ceil(len(r) / predictor.batch_size)
                    for r in requests)
    # the main path: counts to 0 just before, read just after
    for mod in KERNELS:
        mod.launches = 0
    outs, walls = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(predictor(req))
        walls.append(time.perf_counter() - t0)
    launches = {mod.NAME: mod.launches for mod in KERNELS}
    print(f"served {[len(r) for r in requests]} graphs in {n_batches} "
          f"batches, {[f'{w:.3f}' for w in walls]} s; kernel launches "
          f"{launches}")
    expected = {mod.NAME: 0 for mod in KERNELS}
    expected[k5.FWD.NAME] = DENSE["num_layer"] * n_batches
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")

    full, part, again = outs
    for o, req in zip(outs, requests):
        if o.shape != (len(req), 1) or not np.isfinite(o).all():
            raise AssertionError(f"bad output {o.shape}, finite "
                                 f"{np.isfinite(o).all()}")
    rep = max(float(np.abs(again - full).max()),
              float(np.abs(part - full[subset]).max()))
    print(f"repeated graphs: max abs difference {rep:.3e} "
          f"(tolerance {REPEAT_TOL:g}); predictions range "
          f"[{full.min():.4f}, {full.max():.4f}]")
    if not rep <= REPEAT_TOL:
        raise AssertionError(f"repeated graphs differ by {rep}")

    t0 = time.perf_counter()
    cpu = MaPredictor(copy.deepcopy(model).cpu(), sampler, batch_size=128,
                      device="cpu")
    cpu_full, cpu_part = cpu(datas), cpu([datas[i] for i in subset])
    diff = max(float(np.abs(cpu_full - full).max()),
               float(np.abs(cpu_part - part).max()))
    print(f"card vs CPU (plain versions, {time.perf_counter() - t0:.3f} s "
          f"on the CPU): max abs difference {diff:.3e} (tolerance "
          f"{DENSE_SERVE_TOL:g})")
    if not diff <= DENSE_SERVE_TOL:
        raise AssertionError(f"card and CPU disagree by {diff}")

    sync()
    t0 = time.perf_counter()
    predictor(graphs)
    raw_s = time.perf_counter() - t0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor(datas)
    pre_s = (time.perf_counter() - t0) / reps
    breakdown(model, predictor, datas, dev)
    return len(graphs) / raw_s, len(graphs) / pre_s, launches


def dense_train_run(device, batches, steps, per_step=None):
    """PPGN-DD 6x128 from seed 0, ``steps`` AdamW steps at DENSE_LR on
    ``batches`` through the port's ``make_dense_steps``.  Returns the
    per-step losses and the model."""
    from pygho_tpu_torch.models import make_dense_steps, make_optimizer

    model = dense_model(device)
    model.train()
    opt = make_optimizer(model, DENSE_LR)
    train_step, _ = make_dense_steps()
    losses = []
    for i, batch in enumerate(batches[:steps]):
        losses.append(train_step(model, opt, batch))
        if per_step is not None:
            per_step(i)
    return [float(x) for x in losses], model


def train_dense(card, dev):
    """PPGN-DD 6x128 trains on the card: 6 launches of each K5 role a
    step, finite losses, two runs bitwise identical, the CPU's losses
    within DENSE_TRAIN_RTOL over DENSE_CPU_STEPS steps; then graphs/s
    trained and the peak device memory.  Returns the launches of the
    first training run."""
    import torch

    from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                        spdsampler, synthetic_zinc)
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.models import make_dense_steps, make_optimizer

    t0 = time.perf_counter()
    pre = Mapretransform(partial(spdsampler, hop=DENSE_HOP))
    datas = [pre(g) for g in synthetic_zinc("train", seed=SEED)]
    loader = MaDataloader(datas, 128, shuffle=True, drop_last=True, seed=0)
    batches = []
    while len(batches) < TRAIN_STEPS:      # 8 batches an epoch
        batches.extend(loader)
    batches = batches[:TRAIN_STEPS]
    print(f"dense training data: {len(datas)} graphs of synthetic_zinc("
          f"\"train\"), {TRAIN_STEPS} shuffled batches of 128 (loader seed "
          f"0, n padded to {batches[0]['X_data'].shape[1]}), preprocessed "
          f"and collated in {time.perf_counter() - t0:.3f} s")

    counts = []

    def read(_):
        counts.append({mod.NAME: mod.launches for mod in KERNELS})

    sync()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read after every step
    for mod in KERNELS:
        mod.launches = 0
    t0 = time.perf_counter()
    losses, model = dense_train_run(dev, batches, TRAIN_STEPS, read)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"trained {TRAIN_STEPS} steps in {run_s:.3f} s; losses "
          f"{[f'{x:.6f}' for x in losses]}; kernel launches {launches}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB")
    want = {mod.NAME: DENSE["num_layer"]
            if mod.SOURCE.endswith("channelwise_bmm.cu") else 0
            for mod in KERNELS}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    again, model2 = dense_train_run(dev, batches, TRAIN_STEPS)
    state, state2 = model.state_dict(), model2.state_dict()
    same = again == losses and all(torch.equal(state[k], state2[k])
                                   for k in state)
    print(f"second run from the same seed: losses and all {len(state)} "
          f"parameters and buffers bitwise identical: {same}")
    if not same:
        raise AssertionError(f"two runs differ: {losses} vs {again}")
    del model, model2, state, state2

    t0 = time.perf_counter()
    cpu_losses, _ = dense_train_run("cpu", batches, DENSE_CPU_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"card vs CPU (plain versions), the first {DENSE_CPU_STEPS} steps "
          f"in {time.perf_counter() - t0:.3f} s on the CPU: max relative "
          f"loss difference {rel:.3e} (tolerance {DENSE_TRAIN_RTOL:g}); CPU "
          f"losses {[f'{x:.6f}' for x in cpu_losses]}")
    if not rel <= DENSE_TRAIN_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")

    # graphs/s trained: one epoch of 8 steps after a warm-up epoch,
    # collation included, one sync at the end
    model = dense_model(dev)
    model.train()
    opt = make_optimizer(model, DENSE_LR)
    train_step, _ = make_dense_steps()
    for batch in loader:
        train_step(model, opt, batch)
    sync()
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        train_step(model, opt, batch)
        n += 128
    sync()
    gps = n / (time.perf_counter() - t0)
    dev_ms = time_ms(lambda: train_step(model, opt, batches[0]),
                     lambda: None, reps=5, warmup=1, settle=False)
    print(f"PPGN-DD 6x128 training on {card}: {gps:.1f} graphs/s trained "
          f"(one epoch of 8 steps, collation included); one step "
          f"{dev_ms:.3f} ms between CUDA events (median of 5, copy "
          f"included); peak device memory {peak / 2 ** 30:.3f} GiB "
          f"({peak} bytes)")
    return launches


def main():
    t_all = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not (REPO / "pygho_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"pygho_tpu_torch not found beside {__file__}; "
                         f"run chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    # before the first CUDA call: the package sets the cuBLAS workspace
    # that the parity mode's deterministic algorithms need
    import pygho_tpu_torch  # noqa: F401

    t0 = phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a card")
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {kind}")
    done("device", t0)

    from pygho_tpu_torch.kernels import KERNELS, _build
    from pygho_tpu_torch.models.serve import set_parity_numerics

    t0 = phase("build")
    names = sorted({Path(mod.SOURCE).stem for mod in KERNELS})
    secs = _build.build(names)
    for name in names:
        print(f"built {name} in {secs[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line \
                    or "Function properties" in line:
                print(f"  {line.strip()}")
    done("build", t0)

    set_parity_numerics()
    from pygho_tpu_torch.hodata import (KhopSampler, Mapretransform,
                                        Sppretransform, spdsampler,
                                        synthetic_zinc)

    graphs = synthetic_zinc("val", seed=SEED)
    rng = np.random.default_rng(0)
    flush_buf = torch.empty(64 * 2 ** 20, device=dev)   # 256 MB > L2

    t0 = phase("kernels")
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in graphs]
    report = check_k1(datas, dev, rng, flush_buf.zero_)
    dense_pre = Mapretransform(partial(spdsampler, hop=DENSE_HOP))
    report += check_k5([dense_pre(g) for g in graphs], dev, rng,
                       flush_buf.zero_)
    report += check_k4(datas, dev, rng, flush_buf.zero_)
    t1 = time.perf_counter()
    giant = giant_instance()
    print(f"giant graph built in {time.perf_counter() - t1:.3f} s on the "
          f"host (RCM, hop-1 tuples and triples, inputs)")
    report += check_k3(giant, dev, rng, flush_buf.zero_)
    done("kernels", t0)

    t0 = phase("serving")
    raw_gps, pre_gps, launches = serve(graphs, rng, dev)
    print(f"NGNN-SS 6x128 serving on {card}: {raw_gps:.1f} graphs/s from "
          f"raw graphs (host precompute included), {pre_gps:.1f} graphs/s "
          f"from preprocessed graphs")
    done("serving", t0)

    t0 = phase("training")
    train_launches = training(card, dev)
    done("training", t0)

    t0 = phase("dense serving")
    raw_gps, pre_gps, dense_launches = serve_dense(graphs, rng, dev)
    print(f"PPGN-DD 6x128 serving on {card}: {raw_gps:.1f} graphs/s from "
          f"raw graphs (host precompute included), {pre_gps:.1f} graphs/s "
          f"from preprocessed graphs")
    done("dense serving", t0)

    t0 = phase("dense training")
    dense_train_launches = train_dense(card, dev)
    done("dense training", t0)

    t0 = phase("NGAT serving")
    raw_gps, pre_gps, ngat_launches = serve(graphs, rng, dev, "NGAT")
    print(f"NGAT-SS 6x128 serving on {card}: {raw_gps:.1f} graphs/s from "
          f"raw graphs (host precompute included), {pre_gps:.1f} graphs/s "
          f"from preprocessed graphs")
    done("NGAT serving", t0)

    t0 = phase("NGAT training")
    ngat_train_launches = training(card, dev, "NGAT")
    done("NGAT training", t0)

    t0 = phase("giant training")
    giant_launches = train_giant(card, dev, giant)
    done("giant training", t0)

    # launches: each main path's run (NGNN serving and training, dense
    # serving and training, NGAT serving and training, giant-graph
    # training), each counted from 0 just before the path and read just
    # after
    for line in report:
        line["launches"] = sum(
            run[line["name"]] for run in (launches, train_launches,
                                          dense_launches,
                                          dense_train_launches,
                                          ngat_launches,
                                          ngat_train_launches,
                                          giant_launches))
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": report}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
