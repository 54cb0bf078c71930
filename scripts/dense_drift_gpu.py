"""Where PPGN-DD 6x128's card and CPU training runs part, on one CUDA card.

    python3 scripts/dense_drift_gpu.py

The model is ``chip_smoke.py``'s dense configuration (weights from seed
0), the batches its first three shuffled 128-graph batches of
``synthetic_zinc("train")``.  Prints the card's name and power limit; for
the first batch's backward, the parameters whose gradients differ most
between the card and the CPU (relative difference, gradient norm) and the
median relative difference over all parameters; then the losses of three
AdamW steps on the card and on the CPU at lr 1e-3 and at 4.5e-3, with
their relative differences.  A CPU step takes tens of seconds.  It
imports nothing of JAX and needs a card.
"""
import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import pygho_tpu_torch  # noqa: E402,F401  (sets the cuBLAS workspace)
import chip_smoke as cs  # noqa: E402
from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,  # noqa: E402
                                    batch_to_dense_dict, spdsampler,
                                    synthetic_zinc)
from pygho_tpu_torch.models import make_dense_steps, masked_l1_loss  # noqa: E402,E501


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures a card")
    print(cs.card_line())
    pre = Mapretransform(partial(spdsampler, hop=cs.DENSE_HOP))
    datas = [pre(g) for g in synthetic_zinc("train", seed=cs.SEED)]
    batches = list(MaDataloader(datas, 128, shuffle=True, drop_last=True,
                                seed=0))[:3]
    make_dense_steps()   # the parity mode
    grads = {}
    for dev in ("cuda", "cpu"):
        m = cs.dense_model(dev)
        m.train()
        dd = batch_to_dense_dict(batches[0], ("",), torch.device(dev))
        masked_l1_loss(m(dd), dd["y"], dd["graph_mask"]).backward()
        # the adjacency's embedding gets no gradient: PPGN does not read A
        grads[dev] = {k: p.grad.detach().cpu()
                      for k, p in m.named_parameters() if p.grad is not None}
    rows = sorted(((float((grads["cuda"][k] - g).norm()
                          / g.norm().clamp_min(1e-30)), float(g.norm()), k)
                   for k, g in grads["cpu"].items()), reverse=True)
    print("largest relative gradient differences card vs CPU (rel, |grad|, "
          "name):")
    for rel, norm, name in rows[:8]:
        print(f"  {rel:.3e} {norm:.3e} {name}")
    print("median relative difference", float(np.median([r[0] for r in rows])))
    for lr in (1e-3, 4.5e-3):
        cs.DENSE_LR = lr
        card, _ = cs.dense_train_run("cuda", batches, 3)
        cpu, _ = cs.dense_train_run("cpu", batches, 3)
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        print(f"lr {lr}: card {card} cpu {cpu} rel {rel}")


if __name__ == "__main__":
    main()
