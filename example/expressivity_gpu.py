"""The substructure-counting benchmark with the PyTorch / CUDA port
(``pygho_tpu_torch``): the port of ``example/expressivity_tpu.py`` for its
count task, with the same flag names and defaults.

  python example/expressivity_gpu.py --dataset count --conv I2GNN
  python example/expressivity_gpu.py --dataset count --conv I2GNN \\
      --target triangle --epochs 400 --hiddim 128 --num_layer 5 --bs 64 \\
      --lr 3.4e-3 --cosT 26 --minlr 2.03e-5 --wd 3.7e-2 --K 0.011 \\
      --K2 0.0073 --normparam 0.31       (the tuned run of
                                          scripts/matrix_r5.sh)
  python example/expressivity_gpu.py --cpu ...       (on the CPU)

The task is regression of substructure counts (``--target``: one of
``hodata.SUBSTRUCTURES``, or ``all`` for the six at once) on the graphs
of ``synthetic_subgraphcount()``, split 80/20 into training and
validation graphs by a seeded permutation, as the JAX script splits them;
the sparse model (``--conv``; I2GNN takes the 3-tuples of
``I2Sampler(hop=--hop)``, the others ``KhopSampler``) trains through
``make_sparse_steps``, and the best validation MAE is reported.  It
trains on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.

The JAX script's classification tasks (``--dataset`` CSL, EXP and sr25)
and its dense mode (``--dense``) are refused with the ``ROADMAP.md`` item
that ports them: their data is not in the repository, and their
classification steps come with it.  So are the norms other than ``bn``.
Nothing runs in their place.

Each epoch appends a record ``{"type": "epoch", "epoch", "loss", "mae"}``
(the JAX script's) to ``<log-dir>/expr_gpu_count_<target>_<conv>.jsonl``
through ``utils.MetricsLogger``; ``--converged-record PATH`` writes a
summary json at the end: the flags, the best validation MAE and its
epoch, the seconds an epoch and, on the card, the card's name and power
limit.  Preprocessed graphs are cached under ``--cache-dir`` (default
``dataset/torch``).
"""

import argparse
import json
import math
import os
import sys
import time
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def build_parser() -> argparse.ArgumentParser:
    """``example/expressivity_tpu.py``'s flags and defaults, and the
    port's own ``--cache-dir``, ``--log-dir`` and ``--converged-record``
    (``example/zinc_gpu.py``'s)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=["CSL", "EXP", "sr25", "count"],
                        default="CSL")
    parser.add_argument("--conv", default="NGNN")
    parser.add_argument("--target", default="triangle",
                        help="count-dataset regression target: one of "
                             "triangle/tailed_triangle/star/cycle4/cycle5/"
                             "chordal, or 'all' (a 6-task regression)")
    parser.add_argument("--dense", action="store_true",
                        help="not ported (the masked-dense backend)")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--hiddim", type=int, default=64)
    parser.add_argument("--num_layer", type=int, default=4)
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--hop", type=int, default=3)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--cosT", type=int, default=0,
                        help="cosine-warm-restarts period in epochs (0 = "
                             "constant lr)")
    parser.add_argument("--minlr", type=float, default=0.0)
    parser.add_argument("--wd", type=float, default=0.0)
    parser.add_argument("--K", type=float, default=0.0)
    parser.add_argument("--K2", type=float, default=0.0)
    parser.add_argument("--norm", choices=["bn", "ln", "none"], default="bn")
    parser.add_argument("--recalibrate_bn", action="store_true",
                        help="re-estimate batchnorm running stats over the "
                             "training batches before each eval")
    parser.add_argument("--eval_train_mode", action="store_true",
                        help="evaluate with batch statistics")
    parser.add_argument("--normparam", type=float, default=0.1,
                        help="batchnorm momentum")
    parser.add_argument("--cache-dir", type=str, default="dataset/torch",
                        help="root of the preprocessed-dataset caches")
    parser.add_argument("--log-dir", type=str, default="runs",
                        help="directory of the per-epoch jsonl records")
    parser.add_argument("--converged-record", type=str, default=None,
                        help="write the run's summary json to this path")
    return parser


def refusal(args) -> Optional[str]:
    """Why the port cannot run ``args``, naming the ``ROADMAP.md`` item
    that ports what is missing; None where it can."""
    roadmap = "is not ported yet (ROADMAP.md, Queue A item"
    if args.dense and args.conv == "I2GNN":
        return ("I2GNN needs 3-tuple features; the dense pipeline's "
                "spdsampler emits 2-tuples - drop --dense")
    if args.dataset != "count":
        return (f"--dataset {args.dataset} {roadmap} 10): its data is not "
                f"in the repository, and the classification steps come "
                f"with it")
    if args.dense:
        return f"--dense {roadmap} 10)"
    if args.norm != "bn":
        return f"--norm {args.norm} {roadmap} 6)"
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


class CountRun:
    """One run of the count task: the graphs and their split, the model,
    the loaders, the optimizer and the steps (``example/expressivity_tpu.py``
    up to its epoch loop); :meth:`run` is the epoch loop."""

    def __init__(self, args: argparse.Namespace):
        from pygho_tpu_torch.hodata import (I2Sampler, KhopSampler,
                                            ParallelPreprocessDataset,
                                            SpDataloader, Sppretransform,
                                            synthetic_subgraphcount)
        from pygho_tpu_torch.honn import parse_precomputekey
        from pygho_tpu_torch.models import (cosine_warm_restarts,
                                            make_optimizer, make_sp_model,
                                            make_sparse_steps)
        from pygho_tpu_torch.utils import MetricsLogger

        self.args = args
        graphs = synthetic_subgraphcount(target=args.target)
        self.num_tasks = graphs[0].y.shape[0]
        self.tag = f"count_{args.target}"
        rng = np.random.default_rng(0)
        perm = rng.permutation(len(graphs))
        n_val = max(1, len(graphs) // 5)
        val_idx, trn_idx = perm[:n_val], perm[n_val:]

        mlp = {"norm": args.norm, "act": "silu", "normparam": args.normparam}
        self.model = make_sp_model(args.conv, num_tasks=self.num_tasks,
                                   num_layer=args.num_layer,
                                   hiddim=args.hiddim, mlp=mlp,
                                   device="cpu" if args.cpu else None)
        self.device = next(self.model.parameters()).device
        keys = parse_precomputekey(self.model)
        sampler = I2Sampler if args.conv == "I2GNN" else KhopSampler
        ds = ParallelPreprocessDataset(
            os.path.join(args.cache_dir,
                         f"{self.tag}_{args.conv}_h{args.hop}"), graphs,
            Sppretransform(partial(sampler, hop=args.hop), [""], keys), 0)
        self.trn = SpDataloader([ds.datas[i] for i in trn_idx], args.bs,
                                keys, shuffle=True, backward=True)
        self.val = SpDataloader([ds.datas[i] for i in val_idx], args.bs,
                                keys)
        self.train_step, self.eval_step = make_sparse_steps()
        lr = cosine_warm_restarts(args.lr, args.cosT, len(self.trn),
                                  args.minlr, args.K, args.K2) \
            if args.cosT > 0 else args.lr
        self.opt = make_optimizer(self.model, lr, args.wd)
        self.metrics = MetricsLogger(os.path.join(
            args.log_dir, f"expr_gpu_{self.tag}_{args.conv}.jsonl"))

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _recalibrate(self):
        from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
        from pygho_tpu_torch.honn import recalibrate_batchnorm

        recalibrate_batchnorm(
            self.model, list(self.trn),
            lambda m, b: m(batch_to_sparse_dict(b, ("",), self.device)))

    def epoch(self) -> Dict[str, float]:
        """One epoch: training, the optional BatchNorm recalibration, and
        the validation MAE.  Returns its loss, MAE and seconds."""
        import torch

        t0 = time.time()
        self.model.train()
        losses = [self.train_step(self.model, self.opt, b)
                  for b in self.trn]
        loss = float(np.mean(torch.stack(losses).cpu().double().numpy()))
        if self.args.recalibrate_bn:
            self._recalibrate()
        self.model.train(self.args.eval_train_mode)
        tot = torch.stack([self.eval_step(self.model, b)
                           for b in self.val]).cpu().double().sum(0)
        self._sync()
        return {"loss": loss, "mae": float(tot[0] / tot[1]),
                "secs": time.time() - t0}

    def run(self) -> Dict:
        """The epoch loop of ``example/expressivity_tpu.py``: each epoch's
        record and line.  Returns the summary (:meth:`record`)."""
        self.best, self.best_epoch = math.inf, 0
        self.history: List[Dict[str, float]] = []
        for epoch in range(1, self.args.epochs + 1):
            res = self.epoch()
            self.history.append(res)
            if res["mae"] < self.best:
                self.best, self.best_epoch = res["mae"], epoch
            self.metrics.log({"type": "epoch", "epoch": epoch,
                              "loss": res["loss"], "mae": res["mae"]})
            print(f"epoch {epoch} time {res['secs']:.1f}s loss "
                  f"{res['loss']:.4f} val mae {res['mae']:.4f} (best "
                  f"{self.best:.4f})", flush=True)
        self.metrics.close()
        return self.record()

    def record(self) -> Dict:
        """The run's summary: its flags, the best validation MAE and its
        epoch, the median seconds an epoch after the first, and on the
        card its name and power limit."""
        from zinc_gpu import card_name_and_power

        args = self.args
        secs = [h["secs"] for h in self.history]
        rec = {"dataset": self.tag, "conv": args.conv,
               "epochs": args.epochs, "hop": args.hop,
               "hiddim": args.hiddim, "num_layer": args.num_layer,
               "bs": args.bs, "seed": 0,
               "hps": {"lr": args.lr, "minlr": args.minlr, "wd": args.wd,
                       "cosT": args.cosT, "K": args.K, "K2": args.K2,
                       "normparam": args.normparam, "norm": args.norm,
                       "recalibrate_bn": args.recalibrate_bn,
                       "eval_train_mode": args.eval_train_mode},
               "n_train": len(self.trn.dataset),
               "n_val": len(self.val.dataset),
               "best_val_mae": self.best if math.isfinite(self.best)
               else None,
               "best_val_epoch": self.best_epoch,
               "sec_per_epoch_median": float(np.median(secs[1:]))
               if len(secs) > 1 else None}
        if self.device.type == "cuda":
            import torch

            rec["device"] = {"kind": torch.cuda.get_device_name(self.device),
                             "nvidia_smi": card_name_and_power()}
        return rec


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    rec = CountRun(args).run()
    print(f"Final {rec['dataset']} mae: {rec['best_val_mae']:.4f}")
    path = args.converged_record
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"converged record -> {path}", flush=True)
    return rec


if __name__ == "__main__":
    main()
