"""Minimal end-to-end NGNN on a ZINC-style dataset with the PyTorch / CUDA
port (``pygho_tpu_torch``): the workload of ``example/minimal_tpu.py``.

Run: python example/minimal_gpu.py [--cpu] [--epochs N] [--fused]
     [--ckpt DIR]

It trains on the CUDA card unless ``--cpu`` is given; with no card and no
``--cpu`` it raises.  ``--fused`` trains in the fast numerics mode of the
JAX script's ``--fused`` (``set_fused_math(False)``: bf16 fast math in the
message-passing kernel, K1's ``*_f32fast`` variants on the card).
Preprocessing runs in this process.  Each epoch prints one JSON line with
the fields of the JAX package's ``MetricsLogger.log_epoch``.  ``--ckpt
DIR`` saves the model and the optimizer after every epoch to
``DIR/step_<epoch>`` and, where DIR holds a checkpoint, resumes after the
latest (``pygho_tpu_torch.utils``; the layout of ``minimal_tpu.py
--ckpt``, whose orbax checkpoints the port cannot read).
"""

import argparse
import json
import math
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--epochs", type=int, default=20)
parser.add_argument("--hiddim", type=int, default=128)
parser.add_argument("--num_layer", type=int, default=6)
parser.add_argument("--bs", type=int, default=128)
parser.add_argument("--hop", type=int, default=3)
parser.add_argument("--fused", action="store_true",
                    help="route message passing through the fast variants "
                         "of the message-passing kernel (bf16 fast math)")
parser.add_argument("--ckpt", default="", help="checkpoint dir (save per "
                    "epoch; resumes if one exists)")
args = parser.parse_args()

import torch

from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                    Sppretransform, synthetic_zinc)
from pygho_tpu_torch.honn import parse_precomputekey
from pygho_tpu_torch.kernels import set_fused_math
from pygho_tpu_torch.models import (make_optimizer, make_sp_model,
                                    make_sparse_steps)

device = "cpu" if args.cpu else None     # None: the card, or raise
if args.fused:
    set_fused_math(False)   # bf16 fast math in the message-passing kernel

# 1. model (reference example/minimal.py:92-98)
mlpdict = {"norm": "bn", "act": "silu", "dp": 0.0}
model = make_sp_model("NGNN", num_layer=args.num_layer, hiddim=args.hiddim,
                      mlp=mlpdict, device=device)

# 2. preprocessing with the model's precompute keys (minimal.py:107-116)
keys = parse_precomputekey(model)
pre = Sppretransform(partial(KhopSampler, hop=args.hop), [""], keys)
datasets = {split: [pre(g) for g in synthetic_zinc(split)]
            for split in ("train", "val", "test")}

# 3. dataloaders (minimal.py:118-133); training batches carry the
# backward roles' triples
loaders = {
    "train": SpDataloader(datasets["train"], args.bs, keys, shuffle=True,
                          drop_last=True, backward=True),
    "val": SpDataloader(datasets["val"], args.bs, keys),
    "test": SpDataloader(datasets["test"], args.bs, keys),
}

opt = make_optimizer(model, 1e-3)
train_step, eval_step = make_sparse_steps()
on_card = next(model.parameters()).device.type == "cuda"

start_epoch = 1
if args.ckpt:
    import os

    from pygho_tpu_torch.utils import restore_checkpoint, save_checkpoint

    if os.path.isdir(args.ckpt) and any(
            d.startswith("step_") for d in os.listdir(args.ckpt)):
        start_epoch = restore_checkpoint(args.ckpt, model, opt) + 1
        print(f"resumed from epoch {start_epoch - 1}")


def train(dl):
    model.train()
    losses = [train_step(model, opt, batch) for batch in dl]
    return float(torch.stack(losses).mean())


def evaluate(dl):
    model.eval()
    tot = torch.zeros(2, dtype=torch.float64)
    for batch in dl:
        tot += eval_step(model, batch).double().cpu()
    return float(tot[0] / tot[1])


best_val, tst_score = float("inf"), float("inf")
for epoch in range(start_epoch, args.epochs + 1):
    t1 = time.time()
    loss = train(loaders["train"])
    t2 = time.time()
    val = evaluate(loaders["val"])
    if val < best_val:
        best_val = val
        tst_score = evaluate(loaders["test"])
    t3 = time.time()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    print(json.dumps({"type": "epoch", "epoch": epoch, "trn_time": t2 - t1,
                      "val_time": t3 - t2, "mem_gb": mem, "trn_loss": loss,
                      "val_mae": val, "tst_mae": tst_score, "lr": None}),
          flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, model, opt, step=epoch)
    if math.isnan(loss) or math.isnan(val):
        break

print(f"Final test MAE: {tst_score:.4f}")
