"""Where a training step of the PyTorch / CUDA port goes, on one CUDA card.

    python3 scripts/trace_train_gpu.py
        [--model ngnn-ss|ngat-ss|sswl-ss|dssgnn-ss|gnnak-ss|sun-ss|ppgn-ss|
                 ppgn-dd|ngnn-dd|ngnn-dd-bf16|ngnn-sd|ngnn-sd-fused|giant]
        [--steps 5] [--out trace_out]

Trains NGNN-SS 6x128 (weights from seed 0, AdamW at lr 1e-3, through
``make_sparse_steps``), with ``--model ngat-ss`` NGAT-SS 6x128 and with
``--model ppgn-dd`` PPGN-DD 6x128, both as ``chip_smoke.py`` configures
them (AdamW at lr 1e-3 and 4.5e-3, through ``make_sparse_steps`` and
``make_dense_steps``), with ``--model sswl-ss``, ``dssgnn-ss``,
``gnnak-ss``, ``sun-ss`` or ``ppgn-ss`` that subgraph conv at 6x128 as
``chip_smoke.py``'s phase 22 trains it (AdamW at lr 1e-3, on the conv's
precompute keys), with ``--model ngnn-dd`` NGNN-DD 6x128 as
``chip_smoke.py`` configures it (AdamW at lr 1e-2), ``ngnn-dd-bf16`` the
same with bf16 compute, ``ngnn-sd`` in SD mode on the densify route (K5)
and ``ngnn-sd-fused`` on the fused route (K1), on 128-graph batches of
``synthetic_zinc("train")``;
with ``--model giant`` the giant graph of ``chip_smoke.py`` (200 x 100
communities, hiddim 128, 3 layers, SGD at lr 1e-4, through
``parallel/giant.py``), whose "eval forward" is its loss; and prints:

1. the card's name and power limit;
2. the wall time of a step in the parity mode (deterministic algorithms)
   and with deterministic algorithms off, in turns (on, off, off, on),
   each the median over ``--steps`` synchronised steps on pre-collated
   batches; and the same for one eval-mode forward of a batch already on
   the card, as serving runs it;
3. a ``torch.profiler`` trace of ``--steps`` parity-mode steps: the
   operators and kernels that take the most device time, the device's
   busy share of the traced wall time, and the share of the port's own
   kernels (K1, K4, K5 or K3; K1 on NGNN-SD's fused route);
4. for NGAT-SS, one layer's four attention projections (forward and
   backward) beside K4's four roles on the same inputs: the device time
   of their kernels (``torch.profiler``) and the time between CUDA events,
   which includes the host's launch gaps.
   The table and the Chrome trace go to ``--out``.

It imports nothing of JAX and needs a card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import pygho_tpu_torch  # noqa: E402,F401  (sets the cuBLAS workspace)
import torch  # noqa: E402

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=(
        "ngnn-ss", "ngat-ss", "sswl-ss", "dssgnn-ss", "gnnak-ss", "sun-ss",
        "ppgn-ss", "ppgn-dd", "ngnn-dd", "ngnn-dd-bf16", "ngnn-sd",
        "ngnn-sd-fused", "giant"), default="ngnn-ss")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="trace_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")

    from torch.profiler import ProfilerActivity, profile

    from pygho_tpu_torch import hodata
    from pygho_tpu_torch import models

    dev = torch.device("cuda")
    import chip_smoke

    if args.model.endswith("-ss"):
        conv = args.model[:-3].upper()
        keys = chip_smoke.sparse_keys(conv)
        pre = hodata.Sppretransform(partial(hodata.KhopSampler, hop=3),
                                    [""], keys)
        datas = [pre(g) for g in hodata.synthetic_zinc("train")]
        batches = list(hodata.SpDataloader(datas, 128, keys, shuffle=True,
                                           drop_last=True, seed=0,
                                           backward=True))
        model = chip_smoke.sparse_model(conv, dev)
        opt = models.make_optimizer(model, chip_smoke.TRAIN_LR)
        train_step, _ = models.make_sparse_steps()
        to_dict = hodata.batch_to_sparse_dict
        kernel = "seg_att_kernel" if conv == "NGAT" else "spspmm_sum_kernel"
    elif args.model != "giant":
        conv = args.model[:4].upper()
        mode = args.model[5:7].upper()
        dtype = torch.bfloat16 if args.model.endswith("bf16") else None
        plans = args.model.endswith("fused")
        pre = hodata.Mapretransform(partial(hodata.spdsampler,
                                            hop=chip_smoke.DENSE_HOP))
        datas = [pre(g) for g in hodata.synthetic_zinc("train")]
        batches = list(hodata.MaDataloader(datas, 128, shuffle=True,
                                           drop_last=True, seed=0,
                                           denseadj=mode == "DD",
                                           build_plans=plans))
        model = chip_smoke.dense_model(dev, conv, mode, dtype)
        opt = models.make_optimizer(model, chip_smoke.DENSE_CFG[conv][1])
        train_step, _ = models.make_dense_steps()
        to_dict = hodata.batch_to_dense_dict
        kernel = "spspmm_sum_kernel" if plans else "cw_bmm_kernel"
    else:
        from pygho_tpu_torch.parallel import (build_giant_graph_plan,
                                              init_giant_params,
                                              make_giant_graph_step)

        g = chip_smoke.GIANT
        inst = chip_smoke.giant_instance()
        plan = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                      inst["nnz_pad"], inst["n"], 1,
                                      n_edge_rows=inst["Av"].shape[0],
                                      plan_dim=g["hiddim"])
        model = init_giant_params(g["num_layer"], g["hiddim"], device=dev)
        loss_fn, giant_step = make_giant_graph_step(
            plan, g["num_layer"], lr=g["lr"], device=dev)
        inputs = [torch.from_numpy(inst[k]).to(dev)
                  for k in ("Xv", "Av", "y")]
        # one "batch", the whole graph; the step's own SGD, no optimizer
        batches, opt = [inputs], None

        def train_step(model, opt, batch):
            return giant_step(model, *batch)

        def to_dict(batch, annotate, dev):
            return batch

        kernel = "window_spspmm_kernel"
    model.train()

    def steps(n):
        """Median wall ms of n synchronised steps."""
        times = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, batches[i % len(batches)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    steps(3)                                    # warm up
    ab = []
    for det in (True, False, False, True):
        torch.use_deterministic_algorithms(det)
        ab.append((det, steps(args.steps)))
    # the same for one eval-mode forward, as a served batch runs it
    dd = to_dict(batches[0], ("",), dev)
    model.eval()

    def forwards(n):
        times = []
        with torch.inference_mode():
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if args.model == "giant":
                    loss_fn(model, *dd)
                else:
                    model(dd)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    forwards(3)
    fwd_ab = []
    for det in (True, False, False, True):
        torch.use_deterministic_algorithms(det)
        fwd_ab.append((det, forwards(args.steps)))
    model.train()
    torch.use_deterministic_algorithms(True)
    for what, pairs in (("training step", ab), ("eval forward", fwd_ab)):
        for det, ms in pairs:
            print(f"{what} wall time, deterministic algorithms "
                  f"{'on ' if det else 'off'}: {ms:.3f} ms (median of "
                  f"{args.steps})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            train_step(model, opt, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = device_rows(events)
    busy_us = sum(dev_us(e) for e in kernels)
    own_us = sum(dev_us(e) for e in kernels if kernel in e.key)
    print(f"{args.model}: traced {args.steps} steps: wall {wall_ms:.3f} ms "
          f"({wall_ms / args.steps:.3f} ms a step), device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.1%} of the "
          f"wall), {kernel} {own_us / 1e3:.3f} ms "
          f"({own_us / max(busy_us, 1e-9):.1%} of the device time)")
    print("kernels with the most device time, per step:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        print(f"  {dev_us(e) / 1e3 / args.steps:8.3f} ms  "
              f"{e.count / args.steps:6.1f} launches  {e.key[:100]}")
    ops = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CUDA
           and e.key.startswith(("aten::", "autograd::", "Optimizer",
                                 "SpspmmSum", "ChannelwiseBmm",
                                 "SegmentAttention", "WindowSpspmmSum"))]
    print("operators with the most device time (their kernels and their "
          "callees' kernels), per step:")
    for e in sorted(ops, key=lambda e: getattr(
            e, "device_time_total", getattr(e, "cuda_time_total", 0.0)),
            reverse=True)[:20]:
        t = getattr(e, "device_time_total",
                    getattr(e, "cuda_time_total", 0.0))
        print(f"  {t / 1e3 / args.steps:8.3f} ms  {e.count / args.steps:6.1f}"
              f" calls  host {e.self_cpu_time_total / 1e3 / args.steps:7.3f}"
              f" ms self  {e.key[:80]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"trace_train_gpu_{args.model}.txt").write_text(events.table(
        sort_by="self_cuda_time_total", row_limit=80))
    prof.export_chrome_trace(str(out / f"trace_train_gpu_{args.model}.json"))
    gemm_us = sum(dev_us(e) for e in kernels if "gemm" in e.key.lower())
    print(f"GEMM kernels (every Linear, forward and backward): "
          f"{gemm_us / 1e3 / args.steps:.3f} ms a step")

    def turns(pairs):
        return {("det_on" if d else "det_off") + f"_{i}": ms
                for i, (d, ms) in enumerate(pairs)}

    record = {"card": card, "model": args.model, "step_ms": turns(ab),
              "eval_forward_ms": turns(fwd_ab), "traced_wall_ms": wall_ms,
              "device_busy_ms": busy_us / 1e3,
              "own_kernels_ms": own_us / 1e3,
              "gemm_ms": gemm_us / 1e3}
    if args.model == "ngat-ss":
        record.update(projections_vs_k4(model, batches[0], to_dict, dev))
    print(json.dumps(record))


def dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(events):
    """The kernels' and copies' own rows: an operator's row repeats its
    kernels' time, and a user annotation's device row
    ("Optimizer.step#AdamW.step") spans kernels that have rows of their
    own."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def projections_vs_k4(model, batch, to_dict, dev, reps=20):
    """One NGAT layer's four attention projections, forward and backward,
    beside K4's four roles (``SegmentAttention`` forward and backward), on
    the first layer's input shapes with seeded normal values: the device
    time of each one's kernels under ``torch.profiler`` and the median
    time between CUDA events (host launch gaps included), per layer and
    for six layers."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import KEY
    from pygho_tpu_torch.kernels.segment_attention import SegmentAttention
    from pygho_tpu_torch.honn.sp_operator import fetch_backward_orders

    dd = to_dict(batch, ("",), dev)
    conv = model.subggnns[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    nt, ne = dd["X"].nnz_pad, dd["A"].nnz_pad
    D = conv.att1.in_features
    xv = torch.randn(nt, D, device=dev, generator=gen, requires_grad=True)
    av = torch.randn(ne, D, device=dev, generator=gen, requires_grad=True)
    g = torch.randn(nt, D, device=dev, generator=gen)
    gA = torch.randn(ne, D, device=dev, generator=gen)

    def projections():
        outs = (conv.att1(xv), conv.att3(xv), conv.attA(av), conv.att2(xv))
        torch.autograd.backward(outs, (g, g, gA, g))
        return outs

    ops = [o.detach().requires_grad_() for o in projections()]
    acd, rowptr = dd[f"{KEY}___acd"], dd[f"{KEY}___rowptr"]
    bwd = fetch_backward_orders(dd, KEY)

    def attention():
        SegmentAttention.apply(*ops, acd, rowptr, bwd).backward(g)

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def kernel_ms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof.key_averages())
        return sum(dev_us(e) for e in rows) / 1e3 / reps

    out = {}
    layers = len(model.subggnns)
    for what, fn in (("projections", projections), ("k4", attention)):
        out[f"{what}_event_ms_per_layer"] = median_ms(fn)
        out[f"{what}_device_ms_per_layer"] = kernel_ms(fn)
    print(f"one NGAT layer ({nt} tuple rows, {ne} edge rows, D={D}), "
          f"forward and backward, over {reps} runs: the four attention "
          f"projections {out['projections_device_ms_per_layer']:.3f} ms of "
          f"device time ({out['projections_event_ms_per_layer']:.3f} ms "
          f"between CUDA events), K4's four roles (SegmentAttention) "
          f"{out['k4_device_ms_per_layer']:.3f} ms of device time "
          f"({out['k4_event_ms_per_layer']:.3f} ms between CUDA events); "
          f"x{layers} layers: "
          f"{out['projections_device_ms_per_layer'] * layers:.3f} and "
          f"{out['k4_device_ms_per_layer'] * layers:.3f} ms of device time "
          f"a step")
    return out


if __name__ == "__main__":
    main()
