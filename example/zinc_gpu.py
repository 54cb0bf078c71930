"""The ZINC training harness with the PyTorch / CUDA port
(``pygho_tpu_torch``): the port of ``example/zinc_tpu.py``, the reference
example/zinc.py argparse matrix, with the same flag names and defaults.

Run examples:
  python example/zinc_gpu.py --sparse --conv NGNN [--fused]
  python example/zinc_gpu.py --sparse --conv NGAT
  python example/zinc_gpu.py --sparse --conv SUN --fused   (also SSWL,
                                    DSSGNN, GNNAK, PPGN in sparse mode)
  python example/zinc_gpu.py --sparse --conv I2GNN --fused (3-tuples,
                                    I2Sampler(hop=--hop))
  python example/zinc_gpu.py --conv PPGN            (dense / DD mode)
  python example/zinc_gpu.py --conv NGNN --bf16     (dense / DD mode)
  python example/zinc_gpu.py --conv SUN --remat     (dense / DD mode; also
                                    SSWL, DSSGNN, GNNAK)
  python example/zinc_gpu.py --cpu ...              (on the CPU)

It trains on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.  The port runs every sparse conv (NGNN, NGAT, SSWL,
DSSGNN, GNNAK, SUN, PPGN, and I2GNN on the 3-tuples of
``I2Sampler(hop=--hop)``; ``--cpool`` reaches DSSGNN, GNNAK and SUN)
and the dense (DD) NGNN, SSWL, DSSGNN, GNNAK, SUN and PPGN convs
(``--cpool`` again reaching DSSGNN, GNNAK and SUN; ``--remat``
checkpointing each layer), with ``--fused`` (the fast numerics mode of
the sparse kernels, ``set_fused_math(False)``), ``--bf16`` (bf16 compute
over f32 parameters), ``--repeat``/``--seed0``, ``--ntrain``,
``--data-root``/``--full`` (the real ZINC from its raw files) and
``--converged-record``.  An option the port lacks (another aggregation
or norm, dropout, ``--ddp``, ``--chained``, a sparse ``--remat``,
``--plan-measure``) is refused with the ``ROADMAP.md`` item that ports
it; nothing runs in its place, and the JAX script's own refusals (NGAT
and I2GNN are sparse-only) stay.

Each run appends per-epoch records to ``<log-dir>/zinc_gpu_<tag>_r<seed>
.jsonl`` (a name of its own: the JAX script appends to
``runs/zinc_<tag>_r<seed>.jsonl``): a ``padding`` record, then for each
epoch an ``epoch`` record (``MetricsLogger.log_epoch``) and a
``telemetry`` record with the padding buckets that grew
(``bucket_growth``).  The JAX telemetry's ``compiles`` and
``compile_secs_total`` count XLA compiles, which eager PyTorch does not
do, and are left out.  Preprocessed datasets are cached under
``--cache-dir`` (default ``dataset/torch``, a root of the port's own).

``--ckpt DIR`` (the port's own flag, as ``example/minimal_gpu.py``'s)
saves the model, the optimizer and the run's state (the epoch, the best
val MAE and its test MAE, the epoch times and losses, the loaders' shuffle
state and padding buckets) after every epoch, keeping the latest only,
and a run that finds a checkpoint there resumes after its epoch: a run
longer than one sitting goes on where it stopped, its later epochs
computed as an unbroken run would compute them.  The resumed run's jsonl
records are appended to the same file, after a second ``padding`` record.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DENSE_CONVS = ("NGNN", "SSWL", "DSSGNN", "GNNAK", "SUN", "PPGN")


def build_parser() -> argparse.ArgumentParser:
    """``example/zinc_tpu.py``'s flags and defaults, and the port's own
    ``--cache-dir`` and ``--log-dir``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--sparse", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--aggr", choices=["sum", "mean", "max"],
                        default="sum")
    parser.add_argument("--conv", choices=["NGNN", "NGAT", "GNNAK",
                                           "DSSGNN", "SSWL", "SUN", "PPGN",
                                           "I2GNN"], default="NGNN")
    parser.add_argument("--npool", choices=["mean", "sum", "max"],
                        default="sum")
    parser.add_argument("--lpool", choices=["mean", "sum", "max"],
                        default="mean")
    parser.add_argument("--cpool", choices=["mean", "sum", "max"],
                        default="mean")
    parser.add_argument("--mlplayer", type=int, default=1)
    parser.add_argument("--outlayer", type=int, default=2)
    parser.add_argument("--norm", choices=["ln", "bn", "none"],
                        default="bn")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--minlr", type=float, default=0.0)
    parser.add_argument("--wd", type=float, default=0.0)
    parser.add_argument("--dp", type=float, default=0.0)
    parser.add_argument("--bs", type=int, default=128)
    parser.add_argument("--normparam", type=float, default=0.1)
    parser.add_argument("--cosT", type=int, default=100)
    parser.add_argument("--K", type=float, default=0.0)
    parser.add_argument("--K2", type=float, default=0.0)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--seed0", type=int, default=0,
                        help="first seed index (seeds seed0 .. seed0 + "
                             "repeat - 1)")
    parser.add_argument("--ntrain", type=int, default=None,
                        help="training-set size (default 1024 synthetic "
                             "graphs; 10000 matches the reference's "
                             "ZINC-subset scale)")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--hop", type=int, default=3)
    parser.add_argument("--num_layer", type=int, default=6)
    parser.add_argument("--hiddim", type=int, default=128)
    parser.add_argument("--fused", action="store_true",
                        help="bf16 fast math in the message-passing kernels "
                             "(sparse)")
    parser.add_argument("--plan-measure", action="store_true",
                        help="not ported (the JAX kernels' measured plan "
                             "geometry)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 activations/compute (sparse or dense), "
                             "MLPs and norms (params stay f32); composes "
                             "with --fused")
    parser.add_argument("--ddp", type=int, default=0,
                        help="not ported (data-parallel over N devices)")
    parser.add_argument("--remat", action="store_true",
                        help="layer-level rematerialization (dense; not "
                             "ported for --sparse)")
    parser.add_argument("--chained", action="store_true",
                        help="not ported (whole-epoch training)")
    parser.add_argument("--data-root", type=str, default=None,
                        help="path to a real ZINC dataset root "
                             "(<root>/raw/{split}.pickle[+.index], the PyG "
                             "ZINC raw layout); default: synthetic_zinc")
    parser.add_argument("--converged-record", type=str, default=None,
                        help="write a converged-protocol summary json "
                             "(best-val/test MAE, s/epoch) to this path")
    parser.add_argument("--full", action="store_true",
                        help="with --data-root: use the full 250k ZINC "
                             "instead of the 12k benchmark subset")
    parser.add_argument("--cache-dir", type=str, default="dataset/torch",
                        help="root of the preprocessed-dataset caches")
    parser.add_argument("--log-dir", type=str, default="runs",
                        help="directory of the per-epoch jsonl records")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint directory: save after every "
                             "epoch, resume from the latest there")
    return parser


def refusal(args) -> Optional[str]:
    """Why the port cannot run ``args``, naming the ``ROADMAP.md`` item
    that ports what is missing; None where it can."""
    roadmap = "is not ported yet (ROADMAP.md, Queue A item"
    if args.conv == "NGAT" and not args.sparse:
        return ("NGAT is sparse-only (spspmpnn attention path); add "
                "--sparse")
    if args.conv == "I2GNN" and not args.sparse:
        return ("I2GNN needs 3-tuple features; the dense pipeline's "
                "spdsampler emits 2-tuples - add --sparse")
    if not args.sparse and args.conv not in DENSE_CONVS:
        return f"dense --conv {args.conv} {roadmap} 9)"
    if args.sparse and args.aggr != "sum":
        item = 8 if args.conv == "NGAT" else 6
        return f"--aggr {args.aggr} with --sparse {roadmap} {item})"
    if args.sparse and args.lpool == "max":
        return f"--lpool max with --sparse {roadmap} 6)"
    if args.sparse and args.cpool == "max" \
            and args.conv in ("DSSGNN", "GNNAK", "SUN"):
        return f"--cpool max with --sparse {roadmap} 6)"
    if args.norm != "bn":
        return f"--norm {args.norm} {roadmap} 6)"
    if args.dp != 0.0:
        return f"--dp (dropout) {roadmap} 6)"
    if args.remat and args.sparse:
        return f"--remat with --sparse {roadmap} 6)"
    if args.ddp > 1:
        return f"--ddp {roadmap} 12)"
    if args.chained:
        return f"--chained {roadmap} 4)"
    if args.plan_measure:
        return (f"--plan-measure {roadmap} 10): it times the JAX "
                f"kernels' plan geometries, and the port's kernels take "
                f"none")
    return None


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The parsed flags; ``parser.error`` (exit 2) for an option the port
    lacks."""
    parser = build_parser()
    args = parser.parse_args(argv)
    why = refusal(args)
    if why:
        parser.error(why)
    return args


def card_name_and_power() -> Optional[str]:
    """``name, power.limit`` of the first card from ``nvidia-smi``, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


class ZincRun:
    """One seed's run of the harness: the model, the datasets and
    loaders, the optimizer and the steps (``example/zinc_tpu.py``
    ``run_once`` up to its epoch loop).  :meth:`train_epoch` and
    :meth:`split_mae` are one epoch's training and one split's MAE;
    :meth:`run` is the epoch loop."""

    def __init__(self, args: argparse.Namespace, rep: int):
        import torch

        from pygho_tpu_torch.hodata import (I2Sampler, KhopSampler,
                                            MaDataloader,
                                            Mapretransform,
                                            ParallelPreprocessDataset,
                                            SpDataloader, Sppretransform,
                                            load_zinc, padding_stats,
                                            spdsampler, synthetic_zinc)
        from pygho_tpu_torch.honn import parse_precomputekey
        from pygho_tpu_torch.models import (cosine_warm_restarts,
                                            make_dense_steps, make_ma_model,
                                            make_optimizer, make_sp_model,
                                            make_sparse_steps)
        from pygho_tpu_torch.utils import MetricsLogger

        self.args, self.rep = args, rep
        device = "cpu" if args.cpu else None   # None: the card, or raise
        mlpdict = {"dp": args.dp, "norm": args.norm, "act": "silu",
                   "normparam": args.normparam, "numlayer": args.mlplayer,
                   "tailact": True}
        dtype = torch.bfloat16 if args.bf16 else None
        if args.sparse:
            self.model = make_sp_model(
                args.conv, num_layer=args.num_layer, hiddim=args.hiddim,
                aggr=args.aggr, npool=args.npool, lpool=args.lpool,
                cpool=args.cpool, outlayer=args.outlayer, mlp=mlpdict,
                seed=rep, dtype=dtype, device=device)
            keys = parse_precomputekey(self.model)
            sampler = I2Sampler if args.conv == "I2GNN" else KhopSampler
            pre = Sppretransform(partial(sampler, hop=args.hop), [""], keys)
            self.tag = f"sp_{args.conv}_h{args.hop}"
        else:
            self.model = make_ma_model(
                args.conv, num_layer=args.num_layer, hiddim=args.hiddim,
                npool=args.npool, lpool=args.lpool, cpool=args.cpool,
                outlayer=args.outlayer, mlp=mlpdict, seed=rep, dtype=dtype,
                remat=args.remat, device=device)
            pre = Mapretransform(partial(spdsampler, hop=args.hop), [""])
            self.tag = f"ma_{args.conv}_h{args.hop}"
        self.device = next(self.model.parameters()).device

        if args.data_root:
            def raw(s):
                gs = load_zinc(args.data_root, s, subset=not args.full)
                return gs[: args.ntrain] if s == "train" and args.ntrain \
                    else gs
            self.dstag = "ZINC" + ("full" if args.full else "")
        else:
            def raw(s):
                return synthetic_zinc(
                    s, n_graphs=args.ntrain if s == "train" else None)
            self.dstag = "SYNZINC"
        self.ds = {s: ParallelPreprocessDataset(
            os.path.join(args.cache_dir, f"{self.dstag}_{self.tag}_{s}"
                         + (f"_n{args.ntrain}" if s == "train"
                            and args.ntrain else "")), raw(s), pre, 0)
            for s in ("train", "val", "test")}
        if args.sparse:
            def mk(split, **kw):
                return SpDataloader(self.ds[split].datas, args.bs, keys,
                                    **kw)
            self.train_step, self.eval_step = make_sparse_steps()
            train_kw = {"backward": True}
        else:
            def mk(split, **kw):
                return MaDataloader(self.ds[split].datas, args.bs, **kw)
            self.train_step, self.eval_step = make_dense_steps()
            train_kw = {}
        self.loaders = {"train": mk("train", shuffle=True, drop_last=True,
                                    **train_kw),
                        "val": mk("val"), "test": mk("test")}
        sched = cosine_warm_restarts(args.lr, args.cosT,
                                     len(self.loaders["train"]), args.minlr,
                                     args.K, args.K2)
        self.opt = make_optimizer(self.model, sched, args.wd)
        self.metrics = MetricsLogger(os.path.join(
            args.log_dir, f"zinc_gpu_{self.tag}_r{rep}.jsonl"))
        # one-time padding-waste report (host-side collation only)
        probe = self.loaders["train"]._collate(
            self.ds["train"].datas[: min(args.bs,
                                         len(self.ds["train"].datas))])
        self.metrics.log({"type": "padding", **padding_stats(probe)})
        for ld in self.loaders.values():
            ld.buckets.drain_events()   # the probe's growth is not a batch's

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self) -> float:
        """One epoch of training; the mean of the steps' losses."""
        import torch

        self.model.train()
        losses = [self.train_step(self.model, self.opt, b)
                  for b in self.loaders["train"]]
        return float(np.mean(torch.stack(losses).cpu().double().numpy()))

    def split_mae(self, split: str) -> float:
        """The MAE over the real graphs of ``split``, in eval mode."""
        import torch

        self.model.eval()
        parts = [self.eval_step(self.model, b) for b in self.loaders[split]]
        tot = torch.stack(parts).cpu().double().sum(0)
        return float(tot[0] / tot[1])

    def run(self, on_epoch: Optional[Callable[[int, "ZincRun"], None]]
            = None) -> Dict:
        """The epoch loop of ``example/zinc_tpu.py``: train, val MAE, test
        MAE where val improves, the records; ``on_epoch(epoch, self)``
        after each epoch's records.  With ``--ckpt`` it resumes after the
        checkpoint there and saves one after every epoch.  Returns the
        converged-protocol summary (:meth:`record`)."""
        from pygho_tpu_torch.utils import device_memory_stats

        args = self.args
        self.best_val, self.tst, self.best_epoch = math.inf, math.inf, 0
        self.epoch_times, self.losses = [], []
        ckpt = args.ckpt and os.path.join(args.ckpt, f"r{self.rep}")
        start = self.restore(ckpt) + 1 if ckpt else 1
        for epoch in range(start, args.epochs + 1):
            t1 = time.time()
            loss = self.train_epoch()
            self._sync()
            t2 = time.time()
            val = self.split_mae("val")
            if val < self.best_val:
                self.best_val, self.best_epoch = val, epoch
                self.tst = self.split_mae("test")
            t3 = time.time()
            self.epoch_times.append(t2 - t1)
            self.losses.append(loss)
            mem = device_memory_stats(self.device).get("peak_gb_in_use",
                                                       0.0)
            self.metrics.log_epoch(epoch, t2 - t1, t3 - t2, mem, loss, val,
                                   self.tst)
            growth = [e for ld in self.loaders.values()
                      for e in ld.buckets.drain_events()]
            self.metrics.log({"type": "telemetry", "epoch": epoch,
                              "bucket_growth": growth})
            if ckpt:
                self.save(ckpt, epoch)
            if on_epoch is not None:
                on_epoch(epoch, self)
            if math.isnan(loss) or math.isnan(val):
                break
        self.metrics.close()
        return self.record()

    _STATE = "run_state.json"

    def save(self, path: str, epoch: int) -> None:
        """The checkpoint of ``epoch`` under ``path`` (model, optimizer,
        and the run's state beside them); older ones are removed."""
        import shutil

        from pygho_tpu_torch.utils import save_checkpoint

        d = save_checkpoint(path, self.model, self.opt, epoch)
        state = {"epoch": epoch, "best_val": self.best_val, "tst": self.tst,
                 "best_epoch": self.best_epoch,
                 "epoch_times": self.epoch_times, "losses": self.losses,
                 "loaders": {k: {"rng": ld.rng.bit_generator.state,
                                 "buckets": dict(ld.buckets)}
                             for k, ld in self.loaders.items()}}
        with open(os.path.join(d, self._STATE), "w") as f:
            json.dump(state, f)
        for old in os.listdir(path):
            if old.startswith("step_") and old != os.path.basename(d):
                shutil.rmtree(os.path.join(path, old))

    def restore(self, path: str) -> int:
        """Restore the latest checkpoint under ``path`` into this run, and
        return its epoch; 0 where there is none."""
        from pygho_tpu_torch.utils import restore_checkpoint

        if not os.path.isdir(path) or not any(
                d.startswith("step_") for d in os.listdir(path)):
            return 0
        epoch = restore_checkpoint(path, self.model, self.opt)
        with open(os.path.join(path, f"step_{epoch}", self._STATE)) as f:
            state = json.load(f)
        self.best_val, self.tst = state["best_val"], state["tst"]
        self.best_epoch = state["best_epoch"]
        self.epoch_times, self.losses = state["epoch_times"], state["losses"]
        for k, ld in self.loaders.items():
            ld.rng.bit_generator.state = state["loaders"][k]["rng"]
            ld.buckets.update(state["loaders"][k]["buckets"])
            ld.buckets.drain_events()
        print(f"resumed after epoch {epoch} from {path}", flush=True)
        return epoch

    def record(self) -> Dict:
        """The converged-protocol summary, with the keys of
        ``runs/converged/NGNN_sparse.s0.json`` and, on the card, the
        card's name and power limit under ``device``."""
        args = self.args

        def fin(x):
            return float(x) if np.isfinite(x) else None

        rec = {"dataset": self.dstag, "conv": args.conv,
               "mode": "sparse" if args.sparse else "dense",
               "fused": args.fused, "bf16": args.bf16,
               "ntrain": args.ntrain, "epochs": args.epochs,
               "hop": args.hop, "hiddim": args.hiddim,
               "num_layer": args.num_layer, "bs": args.bs,
               "seed": self.rep,
               "hps": {"lr": args.lr, "minlr": args.minlr, "wd": args.wd,
                       "cosT": args.cosT, "K": args.K, "K2": args.K2,
                       "normparam": args.normparam, "aggr": args.aggr,
                       "npool": args.npool, "lpool": args.lpool,
                       "cpool": args.cpool, "mlplayer": args.mlplayer,
                       "outlayer": args.outlayer, "norm": args.norm},
               "best_val_mae": fin(self.best_val),
               "best_val_epoch": self.best_epoch,
               "tst_mae_at_best_val": fin(self.tst),
               "sec_per_epoch_median": float(np.median(self.epoch_times[1:]))
               if len(self.epoch_times) > 1 else None}
        if self.device.type == "cuda":
            import torch

            rec["device"] = {"kind": torch.cuda.get_device_name(self.device),
                             "nvidia_smi": card_name_and_power()}
        return rec


def write_record(args, rec: Dict, rep: int) -> str:
    """Writes ``rec`` to ``--converged-record``, with ``.s<seed>`` before
    the suffix where more than one seed runs or ``--seed0`` > 0."""
    path = args.converged_record
    if args.repeat > 1 or args.seed0 > 0:
        stem, ext = os.path.splitext(path)
        path = f"{stem}.s{rep}{ext}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"converged record -> {path}", flush=True)
    return path


def run_once(args, rep: int, on_epoch=None) -> Dict:
    """One seed: the run, in the fast numerics mode where ``--sparse
    --fused`` asks for it (the flag restored after), and its record
    written where ``--converged-record`` asks."""
    from pygho_tpu_torch.kernels import get_fused_math, set_fused_math

    old = get_fused_math()
    try:
        if args.sparse and args.fused:
            set_fused_math(False)
        rec = ZincRun(args, rep).run(on_epoch)
    finally:
        set_fused_math(old)
    if args.converged_record:
        write_record(args, rec, rep)
    return rec


def main(argv: Optional[List[str]] = None) -> List[float]:
    args = parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    scores = [run_once(args, r)["tst_mae_at_best_val"]
              for r in range(args.seed0, args.seed0 + args.repeat)]
    scores = [math.nan if s is None else s for s in scores]
    print(f"All {np.average(scores)} {np.std(scores)}")
    return scores


if __name__ == "__main__":
    main()
