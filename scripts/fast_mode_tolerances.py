"""How far the fast numerics mode moves a training run when the f32 values
under it change in their last bits, on the CPU with the plain versions.

    python scripts/fast_mode_tolerances.py [--steps 10] [--runs NGNN-f32,...]

``chip_smoke.py`` holds the card's losses against the CPU's.  In the exact
mode the two differ by the order of f32 sums; in the fast mode a value
that lies within those last bits of a bf16 rounding boundary rounds the
other way on one side, and the difference grows.  This script measures
that growth without a card: it trains each configuration twice from seed
0 on the batches ``chip_smoke.py`` trains on, the second time with every
BatchNorm taking its batch sums in another order, and prints the largest
relative difference of the per-step losses.  For NGAT in fast mode the
second run also takes the card's bf16-input projections
(``honn.conv.fast_projection``), which the layer takes only for CUDA
tensors.  Runs: NGNN-f32 (exact), NGNN-f32fast, NGNN-bf16fast (bf16
compute), NGAT-f32fast; all at 6x128, batch 128.  About two minutes on
eight cores.  ``NGNNDD-bf16`` (not run by default) does the same for
NGNN-DD 6x128 with bf16 compute on the batches that ``chip_smoke.py``
holds the card against the CPU on (``DENSE_CUT_STEPS`` batches of
``DENSE_CUT`` graphs), the basis of its ``DENSE_BF16_TRAIN_RTOL``.
``GIANT-f32`` and ``GIANT-f32fast`` (not run by default) train the giant
graph of ``chip_smoke.py`` (``GIANT``, its plan under ``overlapped_fused``)
the same way, the second time with every layer's matmul summed in another
order (two halves of the input dim, then their sum), the basis of its
``GIANT_RTOL`` in phase 20 (the fast mode); one to two minutes each.
``SERVE-<conv>`` (not run by default; ``conv`` one of ``chip_smoke.py``'s
``SPARSE`` configurations) serves the 128 graphs that ``chip_smoke.py``
serves, in the exact mode, as its ``serve`` does (weights from seed 0,
BatchNorm statistics from one batch), and serves them again with every
``Linear`` summed over two halves of its input dim, and again with every
``Linear`` summed in f64 and rounded once to f32, each time with the
first run's statistics, and prints the largest absolute difference of
the predictions from the first run's: how far the f32 rounding of the
matrix products moves them, the basis of ``chip_smoke.py``'s
``SERVE_TOLS``.  ``SERVEFAST-<conv>`` does the same in the fast mode
(K1's ``*_f32fast`` roles, whose bf16 roundings flip where the f32
values they round move), the basis of its ``FAST_SERVE_TOL``.  The
seed-0 weights depend on PyTorch's version (its ``trunc_normal_``), so
run it where the card's numbers were taken.
"""

import argparse
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def reordered_batchnorm(module):
    """A BatchNorm forward whose training-mode sums run over the rows in
    reverse order: the same statistics up to the last bits."""
    import torch

    orig = module.BatchNorm.forward

    def forward(self, x, mask=None):
        if not self.training or mask is None:
            return orig(self, x, mask)
        in_dtype = x.dtype
        x = x.float()
        d = x.shape[-1]
        rows = x.reshape(-1, d)
        m = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 1
                                                      - mask.dim()))
        m = m.expand(x.shape[:-1]).reshape(-1, 1).to(x.dtype)
        cnt = m.sum().clamp_min(1.0)
        mean = (rows * m).flip(0).sum(0) / cnt
        var = (((rows - mean) ** 2) * m).flip(0).sum(0) / cnt
        with torch.no_grad():
            self.mean.copy_((1 - self.momentum) * self.mean
                            + self.momentum * mean)
            self.var.copy_((1 - self.momentum) * self.var
                           + self.momentum * var)
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias
        return out.to(in_dtype)

    return orig, forward


def card_projections(conv_module):
    """NGATConv.forward taking ``fast_projection`` on every device."""
    from pygho_tpu_torch.backend.sptensor import SparseTensor
    from pygho_tpu_torch.honn.sp_operator import (_fetch,
                                                  fetch_backward_orders)
    from pygho_tpu_torch.kernels.segment_attention import SegmentAttention

    def forward(self, A, X, datadict):
        tX = conv_module._apply(X, self.lin)
        key = self.keyop.precomputekey
        xv = tX.values
        proj = conv_module.fast_projection
        out = SegmentAttention.apply(
            proj(self.att1, xv), proj(self.att3, xv),
            proj(self.attA, A.values), proj(self.att2, xv),
            _fetch(datadict, key, "acd"), _fetch(datadict, key, "rowptr"),
            fetch_backward_orders(datadict, key), False)
        return SparseTensor(indices=tX.indices, values=out.to(xv.dtype),
                            nnz=tX.nnz, sparse_shape=tX.sparse_shape)

    return forward


def split_matmul(giant_module):
    """A GiantLinear forward that sums ``x @ w`` over two halves of the
    input dim and adds them: the same products up to the last bits."""
    def forward(self, x):
        h = x.shape[-1] // 2
        return (x[:, :h] @ self.w[:h] + x[:, h:] @ self.w[h:]) + self.b

    return giant_module.GiantLinear.forward, forward


def split_linear(utils_module):
    """A ``Linear`` forward (f32) that sums ``x @ W.T`` over two halves of
    the input dim and adds them: the same products up to the last bits."""
    import torch.nn.functional as F

    def forward(self, x):
        h = x.shape[-1] // 2
        x = x.float()
        return (F.linear(x[..., :h], self.weight[:, :h])
                + F.linear(x[..., h:], self.weight[:, h:])) + self.bias

    return utils_module.Linear.forward, forward


def f64_linear(self, x):
    """A ``Linear`` forward summed in f64 and rounded once to f32."""
    import torch.nn.functional as F

    return F.linear(x.double(), self.weight.double(),
                    self.bias.double()).float()


def serve_drift(cs, conv, utils_module):
    """How far ``conv``'s predictions on ``chip_smoke.py``'s served graphs
    move when every ``Linear`` sums in another order
    (:func:`split_linear`) and in f64 (:func:`f64_linear`), with the same
    BatchNorm statistics: ``{variant: max abs difference}``, and the
    largest |prediction|.  In the math mode the caller set."""
    from pygho_tpu_torch.hodata import synthetic_zinc
    from pygho_tpu_torch.honn import parse_precomputekey
    from pygho_tpu_torch.models import SpPredictor

    graphs = synthetic_zinc("val", seed=cs.SEED)
    model = cs.sparse_model(conv, "cpu")
    predictor = SpPredictor(model, cs.sparse_sampler(conv),
                            parse_precomputekey(model), batch_size=128,
                            device="cpu")
    datas = predictor.preprocess(graphs)
    cs.calibrate_batchnorm(model, predictor, datas)
    base = predictor(datas)
    orig, split = split_linear(utils_module)
    drift = {}
    for name, forward in (("split", split), ("f64", f64_linear)):
        utils_module.Linear.forward = forward
        try:
            drift[name] = float(abs(predictor(datas) - base).max())
        finally:
            utils_module.Linear.forward = orig
    return drift, float(abs(base).max())


def giant_run(cs, steps):
    """``train(device, data, steps)`` for the giant graph under
    ``overlapped_fused`` (its steps built in the mode set), with its
    instance as ``data``."""
    from pygho_tpu_torch.parallel import build_giant_graph_plan

    inst = cs.giant_instance()
    plan = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                  inst["nnz_pad"], inst["n"], 1,
                                  strategy="overlapped_fused",
                                  n_edge_rows=inst["Av"].shape[0])

    def train(device, data, n):
        losses, model, _ = cs.giant_train_run(device, data, plan, n)
        return losses, model

    return train, min(steps, cs.GIANT_STEPS), inst


def dense_cut_batches():
    """The cut batches on which ``chip_smoke.py`` holds the NGNN dense
    paths' card losses against the CPU's."""
    import chip_smoke as cs
    from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                        spdsampler, synthetic_zinc)

    pre = Mapretransform(partial(spdsampler, hop=cs.DENSE_HOP))
    datas = [pre(g) for g in synthetic_zinc("train", seed=cs.SEED)]
    loader = MaDataloader(datas, cs.DENSE_CUT, shuffle=True, drop_last=True,
                          seed=0)
    return list(loader)[:cs.DENSE_CUT_STEPS]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--runs", default="NGNN-f32,NGNN-f32fast,"
                        "NGNN-bf16fast,NGAT-f32fast")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from pygho_tpu_torch.hodata import (KhopSampler, SpDataloader,
                                        Sppretransform, synthetic_zinc)
    from pygho_tpu_torch.honn import conv as conv_module
    from pygho_tpu_torch.honn import utils as utils_module
    from pygho_tpu_torch.kernels import set_fused_math
    from pygho_tpu_torch.models.serve import set_parity_numerics
    from pygho_tpu_torch.parallel import giant as giant_module

    set_parity_numerics()
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [cs.KEY])
    datas = [pre(g) for g in synthetic_zinc("train", seed=cs.SEED)]
    loader = SpDataloader(datas, 128, [cs.KEY], shuffle=True,
                          drop_last=True, seed=0, backward=True)
    batches = []
    while len(batches) < args.steps:
        batches.extend(loader)
    batches = batches[:args.steps]
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads; "
          f"{args.steps} batches of 128 graphs as chip_smoke.py trains on")
    for run in args.runs.split(","):
        conv, mode = run.split("-")
        if conv in ("SERVE", "SERVEFAST"):
            t0 = time.perf_counter()
            set_fused_math(conv == "SERVE")
            try:
                drift, top = serve_drift(cs, mode, utils_module)
            finally:
                set_fused_math(True)
            print(f"{run}: max abs prediction difference, every Linear "
                  f"summed by halves {drift['split']:.3e}, in f64 "
                  f"{drift['f64']:.3e} (largest |prediction| {top:.4f}; "
                  f"torch {torch.__version__}; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        exact = not mode.endswith("fast")
        dtype = torch.bfloat16 if mode.startswith("bf16") else None
        if conv == "NGNNDD":
            train = partial(cs.dense_train_run, conv="NGNN", dtype=dtype)
            steps, data = cs.DENSE_CUT_STEPS, dense_cut_batches()
        elif conv == "GIANT":
            train, steps, data = giant_run(cs, args.steps)
        else:
            train = partial(cs.train_run, conv=conv, dtype=dtype)
            steps, data = args.steps, batches
        set_fused_math(exact)
        try:
            t0 = time.perf_counter()
            base, _ = train("cpu", data, steps)
            orig, reordered = reordered_batchnorm(utils_module)
            orig_conv = conv_module.NGATConv.forward
            orig_lin, split = split_matmul(giant_module)
            utils_module.BatchNorm.forward = reordered
            if conv == "NGAT" and not exact:
                conv_module.NGATConv.forward = card_projections(conv_module)
            if conv == "GIANT":
                giant_module.GiantLinear.forward = split
            try:
                other, _ = train("cpu", data, steps)
            finally:
                utils_module.BatchNorm.forward = orig
                conv_module.NGATConv.forward = orig_conv
                giant_module.GiantLinear.forward = orig_lin
        finally:
            set_fused_math(True)
        rel = [abs(a - b) / abs(b) for a, b in zip(other, base)]
        print(f"{run}: per-step relative loss difference "
              f"{[f'{r:.2e}' for r in rel]}; max {max(rel):.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
