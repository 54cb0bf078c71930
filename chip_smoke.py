"""Smoke run of the PyTorch / CUDA port (``pygho_tpu_torch``) on one CUDA
card.

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. device: requires a CUDA card and prints its name and power limit;
2. build: builds every kernel of the main path from ``pygho_tpu_torch/csrc``
   with ``nvcc`` (all sources at once);
3. kernels: holds each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (one 128-graph batch of
   ``synthetic_zinc("val")``, ``KhopSampler(hop=3)``, D = 128) and on edge
   cases, and times both;
4. serving: serves NGNN-SS 6x128 (weights from a seed) through the port's
   ``SpPredictor`` over three requests, checks that every batch went through
   the kernels, that the outputs are finite, ordered and repeatable, and
   that they match the same model run on the CPU with the plain versions.

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
# the same graph served twice on the card: only the plain pooling's atomic
# sums may reorder
REPEAT_TOL = 1e-5


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


def time_ms(fn, flush, reps=30, warmup=5):
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    ``flush`` has evicted the L2 cache (outside the timed span)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_spspmm_sum(datas, dev, rng, flush):
    """K1 at the main path's shapes and on edge cases, against its plain
    version on the card.  Returns the kernel's line of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata.loader import SpDataloader
    from pygho_tpu_torch.kernels import spspmm_sum as k1

    batch = next(iter(SpDataloader(datas, 128, [KEY])))
    acd_np = batch[f"{KEY}___acd"]
    nt, ne = batch["tupleid"].shape[1], batch["edge_index"].shape[1]
    D = 128
    U = np.zeros((nt, D), np.float32)
    V = np.zeros((ne, D), np.float32)
    U[:int(batch["num_tuples"])] = rng.normal(size=(int(batch["num_tuples"]),
                                                    D))
    V[:int(batch["num_edges"])] = rng.normal(size=(int(batch["num_edges"]),
                                                   D))
    U, V = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    acd = torch.from_numpy(acd_np).to(dev)
    rowptr = torch.from_numpy(batch[f"{KEY}___rowptr"]).to(dev)
    k, out_rows = acd.shape[1], rowptr.shape[0] - 1

    def compare(U, V, acd, rowptr):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance); raises where an output row with no triples is not
        0."""
        n = rowptr.shape[0] - 1
        out = k1.spspmm_sum(U, V, acd, rowptr)
        ref = k1.spspmm_sum_plain(U, V, acd, n)
        mag = k1.spspmm_sum_plain(U.abs(), V.abs(), acd, n)
        sync()
        if out.numel() == 0:
            return 0.0, 0.0
        empty = (rowptr[1:] == rowptr[:-1])
        if bool((out[empty] != 0).any()):
            raise AssertionError("K1 wrote a non-zero empty row")
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()))

    err, ratio = compare(U, V, acd, rowptr)
    print(f"K1 main shape: {k} triples, U {tuple(U.shape)}, "
          f"V {tuple(V.shape)}, out {(out_rows, D)}; "
          f"max abs err {err:.3e}, {ratio:.3f} of the tolerance "
          f"{KERNEL_RTOL:g} * sum |terms|")
    if not ratio <= 1.0:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")

    # edge cases: empty rows, one row with many triples, a padded tail,
    # D = 16, a D that is not a multiple of 4 and an unaligned U (both
    # take the scalar loop), no triples at all
    def case(D, rows, u_rows, v_rows, out_rows, misalign=False):
        a = np.sort(rows).astype(np.int64)
        acd = np.stack([a, rng.integers(0, u_rows, a.size),
                        rng.integers(0, v_rows, a.size)]).astype(np.int32)
        rp = np.zeros(out_rows + 1, np.int32)
        rp[1:] = np.cumsum(np.bincount(a, minlength=out_rows))
        Ut = torch.from_numpy(rng.normal(size=(u_rows, D))
                              .astype(np.float32)).to(dev)
        if misalign:
            flat = torch.empty(u_rows * D + 1, device=dev)[1:]
            Ut = flat.view(u_rows, D).copy_(Ut)
        Vt = torch.from_numpy(rng.normal(size=(v_rows, D))
                              .astype(np.float32)).to(dev)
        return compare(Ut, Vt, torch.from_numpy(acd).to(dev),
                       torch.from_numpy(rp).to(dev))

    heavy = np.concatenate([np.full(2000, 5), rng.integers(0, 900, 3000)])
    heavy = heavy[(heavy != 3) & (heavy != 700)]
    cases = {
        "empty + heavy rows, D=128": (128, heavy, 500, 400, 1024),
        "empty + heavy rows, D=16": (16, heavy, 500, 400, 1024),
        "D=13 (scalar loop)": (13, heavy, 500, 400, 1024),
        "unaligned U, D=128 (scalar loop)": (128, heavy, 500, 400, 1024,
                                             True),
        "no triples": (128, np.zeros(0, np.int64), 10, 10, 64),
    }
    for name, args in cases.items():
        e, r = case(*args)
        print(f"K1 edge case {name}: max abs err {e:.3e}, {r:.3f} of the "
              f"tolerance")
        if not r <= 1.0:
            raise AssertionError(f"K1 edge case {name} disagrees: {e}")

    ms = time_ms(lambda: k1.spspmm_sum(U, V, acd, rowptr), flush)
    plain_ms = time_ms(lambda: k1.spspmm_sum_plain(U, V, acd, out_rows),
                       flush)
    # inputs left in L2: the card first spins in place (no memory
    # traffic), so the launch is queued before the start event is reached
    # and the time is the kernel's, not the host's
    warm_ms = time_ms(lambda: k1.spspmm_sum(U, V, acd, rowptr),
                      lambda: torch.cuda._sleep(1_000_000))
    # host cost of one wrapper call: checks, ctypes call, enqueue
    sync()
    t0 = time.perf_counter()
    for _ in range(100):
        k1.spspmm_sum(U, V, acd, rowptr)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    sync()
    # least traffic: every referenced row of U and V read once, c, d and
    # rowptr read once, every output row written once
    u_read = int(torch.unique(acd[1]).numel())
    v_read = int(torch.unique(acd[2]).numel())
    nbytes = (u_read + v_read + out_rows) * D * 4 + k * 2 * 4 \
        + (out_rows + 1) * 4
    flops = 2 * k * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"K1 timing (L2 flushed before each launch, median of 30): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} "
          f"f32 operations at 67 TFLOP/s); kernel with its inputs left "
          f"in L2 {warm_ms:.4f} ms; host time of one wrapper call "
          f"{host_us:.1f} us")
    return {"name": k1.NAME, "route": "cuda", "source": k1.SOURCE,
            "replaces": k1.REPLACES, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def calibrate_batchnorm(model, predictor, datas):
    """Running statistics := the statistics of one batch, so that random
    weights give activations of order 1 in every layer."""
    import torch

    from pygho_tpu_torch.hodata.loader import SpDataloader
    from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
    from pygho_tpu_torch.honn.utils import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    batch = next(iter(SpDataloader(datas, predictor.batch_size,
                                   predictor.keys)))
    with torch.no_grad():
        model(batch_to_sparse_dict(batch, ("",), predictor.device))
    for bn, m in zip(bns, saved):
        bn.momentum = m
    model.eval()


def serve(graphs, rng, dev):
    """NGNN-SS 6x128 through SpPredictor on ``dev``, then on the CPU."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata import KhopSampler
    from pygho_tpu_torch.honn import parse_precomputekey
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.models import SpPredictor, make_sp_model

    model = make_sp_model("NGNN", num_layer=6, hiddim=128, mlp=dict(MLPD),
                          seed=0, device=dev)
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
    expected = {KERNELS[0].NAME: 6 * n_batches}
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
    """Where one 128-graph batch's time goes: host collation, the copy to
    the card, and the forward (host wall time to its synchronised end, and
    device time between CUDA events)."""
    import torch

    from pygho_tpu_torch.hodata.loader import SpDataloader
    from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict

    def median_s(fn):
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    loader = SpDataloader(datas, predictor.batch_size, predictor.keys)
    loader.buckets = predictor._buckets
    collate_s = median_s(lambda: next(iter(loader)))
    batch = next(iter(loader))
    copy_s = median_s(lambda: batch_to_sparse_dict(batch, ("",), dev))
    dd = batch_to_sparse_dict(batch, ("",), dev)
    with torch.inference_mode():
        forward_s = median_s(lambda: model(dd))
        dev_ms = time_ms(lambda: model(dd), lambda: None, reps=reps,
                         warmup=1) if dev.type == "cuda" else 0.0
    print(f"one {predictor.batch_size}-graph batch (median of {reps}): "
          f"host collation {collate_s * 1e3:.3f} ms, copy to the card "
          f"{copy_s * 1e3:.3f} ms, forward {forward_s * 1e3:.3f} ms host "
          f"wall / {dev_ms:.3f} ms between CUDA events")


def main():
    t_all = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not (REPO / "pygho_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"pygho_tpu_torch not found beside {__file__}; "
                         f"run chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

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
    names = [Path(mod.SOURCE).stem for mod in KERNELS]
    secs = _build.build(names)
    for name in names:
        print(f"built {name} in {secs[name]:.2f} s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    done("build", t0)

    set_parity_numerics()
    from pygho_tpu_torch.hodata import (KhopSampler, Sppretransform,
                                        synthetic_zinc)

    graphs = synthetic_zinc("val", seed=SEED)
    rng = np.random.default_rng(0)
    flush_buf = torch.empty(64 * 2 ** 20, device=dev)   # 256 MB > L2

    t0 = phase("kernels")
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in graphs]
    report = [check_spspmm_sum(datas, dev, rng, flush_buf.zero_)]
    done("kernels", t0)

    t0 = phase("serving")
    raw_gps, pre_gps, launches = serve(graphs, rng, dev)
    print(f"NGNN-SS 6x128 serving on {card}: {raw_gps:.1f} graphs/s from "
          f"raw graphs (host precompute included), {pre_gps:.1f} graphs/s "
          f"from preprocessed graphs")
    done("serving", t0)

    for line in report:
        line["launches"] = launches[line["name"]]
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": report}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
