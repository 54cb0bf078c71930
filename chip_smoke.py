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
   the peak device memory;
11. NGNN fast serving: phase 4 in the fast numerics mode
   (``set_fused_math(False)``, the mode of the JAX package's ``--fused``
   runs and of ``runs/converged/NGNN_sparse.s0.json``), f32 parameters and
   activations: six ``spspmm_sum_fwd_f32fast`` launches per batch and no
   other, the CPU's predictions within ``FAST_SERVE_TOL``;
12. NGNN fast training: phase 5 in the fast mode: each ``*_f32fast`` K1
   role six times a step and no ``*_f32`` role, a bitwise-identical second
   run, the CPU's losses (plain versions, fast mode) within the mode's
   tolerance (``TRAIN_TOLS``), graphs/s trained;
13. NGNN bf16 training: the same with ``dtype=torch.bfloat16``
   (``--fused --bf16``), the ``*_bf16fast`` K1 roles;
14. NGAT fast training: phase 9 in the fast mode, the ``*_f32fast`` K4
   roles.

15. NGNN-DD serving: serves NGNN-DD 6x128 (``runs/converged/NGNN_dense.json``,
   weights from a seed) through ``MaPredictor`` as phase 6 does, six K5
   forward launches per batch; the CPU serves the 40-graph request in
   batches of ``DENSE_CUT``;
16. NGNN-DD training: trains it for ten AdamW steps at the row's lr 1e-2
   as phase 7 does (6 + 6 + 6 K5 launches a step, a bitwise-identical
   second run); card and CPU train ``DENSE_CUT_STEPS`` steps on the same
   batches of ``DENSE_CUT`` graphs;
17. NGNN-DD bf16 training: the same with ``dtype=torch.bfloat16``
   (``--bf16``): six launches of each ``cw_bmm_*_bf16`` role a step, the
   peak device memory beside the f32 run's;
18. NGNN-SD serving: ``MaModel(mode="SD")`` on the sparse adjacency
   through ``MaPredictor(denseadj=False)`` (the densify route: K5);
19. NGNN-SD training: phase 16 in SD mode on the densify route (K5's
   three roles) and on the fused route (``MaDataloader(build_plans=True)``:
   K1's three f32 roles six times a step and no K5), each step's time
   printed for both;
20. giant fast training: phase 10 under ``set_fused_math(False)`` with the
   ``overlapped_fused`` strategy (``giant_graph_gpu.py --strategy
   overlapped_fused --fast``): three ``window_spspmm_fwd_f32fast`` and
   three ``window_spspmm_dx_f32fast`` launches a step and nothing else,
   finite losses, a bitwise-identical second run, the CPU's losses (plain
   versions, fast mode) over ``GIANT_FAST_CPU_STEPS`` steps within
   ``GIANT_RTOL``; and one step under ``overlapped`` with the same
   flag, which launches the exact roles, as JAX's XLA contraction ignores
   the flag;
21. ZINC entry point: ``example/zinc_gpu.py``'s run in this process,
   NGNN-SS 6x128 with the converged row's flags (``--fused``) on 1,024
   synthetic training graphs for two epochs with val and test MAE: the K1
   ``*_f32fast`` roles and nothing else, the jsonl records, finite MAE,
   the converged record's keys, and a checkpoint of epoch 1, restored,
   giving epoch 2's loss bit for bit;
22. subgraph convs: SSWL, DSSGNN, GNNAK, SUN and PPGN-SS 6x128 (the model
   settings of their converged rows, ``SPARSE``, weights from seed 0),
   each served as phase 4 serves NGNN-SS (PPGN-SS's predictions within
   ``SERVE_TOLS`` of the CPU's) and trained as phase 5 trains it (ten
   AdamW steps at lr 1e-3 in the exact mode, twice, bitwise; the CPU's
   losses over ``SUBGRAPH_CPU_STEPS`` steps within ``TRAIN_RTOL``),
   with K1's f32 roles and no other kernel launched once a layer and
   precompute key a batch or step: 12 for SSWL (its NGNN key and the
   cross key ``X___A___1___X___0``), 6 for the others (PPGN-SS on the
   2-FWL key ``X___X___1___X___0``); each prints the share of its raw-
   graph serving time that the host's precompute takes;
23. I2GNN: I2GNN-SS 6x128 (its converged row's model settings,
   ``SPARSE["I2GNN"]``: hop 3, mlplayer 2, outlayer 4, normparam 0.31, npool
   sum, lpool mean) on the 3-tuples of ``I2Sampler(hop=3)``, in the exact
   mode and in the fast mode (``set_fused_math(False)``, the mode of its
   ``--fused`` row): served as phase 4 serves NGNN-SS (six K1 forward
   launches a batch, on the key ``X___X___2___A___0``) and trained as
   phase 5 trains it (each K1 role six times a step, twice, bitwise; the
   CPU's losses over ``I2_CPU_STEPS`` steps), with its graphs/s, the host
   precompute's share of the raw-graph serving time and the peak device
   memory; then ``example/expressivity_gpu.py``'s count task in this
   process (I2GNN 5x128 with the tuned flags of ``scripts/matrix_r5.sh``,
   ``COUNT_EPOCHS`` epochs): K1's forward and dX roles and no other kernel
   (the count graphs' adjacency has no values, so no dA role), finite
   losses and validation MAE, the jsonl records;
24. dense subgraph convs: SSWL, DSSGNN, GNNAK and SUN 6x128 in DD and in
   SD mode (``DENSE_CFG``: the dense rows' settings of
   ``scripts/converged_matrix.sh``, weights from seed 0), each served as
   phase 15 serves NGNN-DD (SD through ``MaPredictor(denseadj=False)``,
   the densify route) and trained as phase 16 trains it (ten AdamW steps
   at the row's lr, twice, bitwise; card and CPU on ``DENSE_CUT_STEPS``
   batches of ``DENSE_CUT`` graphs within ``DENSE_SERVE_TOL`` and
   ``DENSE_TRAIN_RTOL``), with K5's f32 roles and no other kernel
   launched once a layer and contraction a batch or step: 12 for SSWL
   (its within-subgraph product at ``(2, 1)`` and its cross-subgraph one
   at ``(1, 1)``, the adjacency read through its transposed strides), 6
   for the others; then SSWL-SD on the fused route
   (``MaDataloader(plan_dims=parse_spmamm_dims(model))``: K1's three f32
   roles 12 times a step on the ``(1, 2)`` and ``(1, 1)`` triples, no
   K5); each with its graphs/s, a step's breakdown and the peak device
   memory.

The kernels phase also holds K5's f32 forward at SSWL's cross-subgraph
layout ``(1, 1)`` (the adjacency through its transposed strides) against
its plain version and times it beside the ``(2, 1)`` launch.

The kernels phase also holds K1's three f32 roles bit for bit against
their plain version at SSWL's cross key (the edge values as the first
operand, the dX role's rows the padded edges) and PPGN-SS's 2-FWL key
(the largest K1 input of any path), with ``SpspmmSum``'s gradients, and
times them beside ``k1_bound``.

The kernels phase also holds K1's f32 and f32fast roles bit for bit
against their plain versions at I2GNN's 3-tuple key ``X___X___2___A___0``
on two batches: 128 graphs of ``synthetic_zinc("val")`` and 64 of
``synthetic_subgraphcount()``, through ``I2Sampler(hop=3)``, with
``SpspmmSum``'s gradients, and times them beside ``k1_bound``.

The kernels phase holds every fast and bf16 variant of K1 and K4 (the
roles of phase 3 with operands stored in f32 or bf16, in the exact or the
fast mode), K3's fast variant (its three roles at the giant shape and on
the edge cases, in the fast mode) and K5's bf16 variant (its three roles
on bf16 operands, the cotangent of dA and dX in f32) the same way, bit
for bit against its
plain version, holds ``SpspmmSum``'s, ``SegmentAttention``'s and
``ChannelwiseBmm``'s and ``WindowSpspmmSum``'s gradients in those modes
against autograd through the plain versions, times each variant beside
its bound and its plain version (K5's also beside ``torch.einsum`` on its
operands), and checks that a variant of K1, K3 or K4 whose launch is
refused raises and counts nothing.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the last line.  It imports nothing of JAX.
"""

import contextlib
import copy
import dataclasses
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
# the cross-subgraph key (SSWL: the edge values are K1's first operand) and
# the 2-FWL key (PPGN-SS: both operands tuple values)
CROSS_KEY = "X___A___1___X___0"
FWL_KEY = "X___X___1___X___0"
# I2GNN's 3-tuple key: the tuple values (i, j, k) times the edge values
# (k, l) onto (i, j, l)
I2_KEY = "X___X___2___A___0"
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
# the subgraph convs of phase 22, 6x128 as their converged JAX rows train
# them (runs/converged/{conv}_sparse.json: KhopSampler(hop=3), batch 128,
# aggr sum, cpool mean, mlplayer 2, outlayer 4, and each row's npool, lpool
# and normparam), with example/zinc_tpu.py's MLP settings, trained at
# TRAIN_LR in the exact mode
SUBGRAPH_CONVS = ("SSWL", "DSSGNN", "GNNAK", "SUN", "PPGN")
SPARSE.update({conv: dict(num_layer=6, hiddim=128, aggr="sum", npool="sum",
                          lpool=lpool, cpool="mean", outlayer=4,
                          mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                               "normparam": normparam, "numlayer": 2,
                               "tailact": True})
               for conv, lpool, normparam in (("SSWL", "mean", 0.22),
                                              ("DSSGNN", "sum", 0.31),
                                              ("GNNAK", "sum", 0.31),
                                              ("SUN", "sum", 0.57),
                                              ("PPGN", "mean", 0.185))})
# I2GNN-SS 6x128 as its converged JAX row trains it
# (scripts/converged_matrix.sh: I2Sampler(hop=3), batch 128, aggr sum,
# mlplayer 2, outlayer 4, npool sum, lpool mean, normparam 0.31), with
# example/zinc_tpu.py's MLP settings, trained at TRAIN_LR (phase 23)
SPARSE["I2GNN"] = dict(num_layer=6, hiddim=128, aggr="sum", npool="sum",
                       lpool="mean", outlayer=4,
                       mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                            "normparam": 0.31, "numlayer": 2,
                            "tailact": True})
# the kernel source each sparse configuration's layers launch, for each
# role once a layer and precompute key
SPARSE_SOURCE = {"NGNN": "spspmm_sum.cu", "NGAT": "segment_attention.cu",
                 "I2GNN": "spspmm_sum.cu",
                 **{conv: "spspmm_sum.cu" for conv in SUBGRAPH_CONVS}}
# each sparse configuration's precompute keys, NGNN's KEY unless given
SPARSE_KEYS = {"SSWL": [CROSS_KEY, KEY], "PPGN": [FWL_KEY],
               "I2GNN": [I2_KEY]}
# the CPU repeats this many of I2GNN's ten steps (98,304 padded 3-tuple
# rows a batch through six layers of the plain K1 and the MLPs)
I2_CPU_STEPS = 2
# the count entry point of phase 23: example/expressivity_gpu.py with the
# tuned flags of scripts/matrix_r5.sh's count run (I2GNN 5x128, batch 64),
# cut to COUNT_EPOCHS epochs
COUNT_ARGS = ["--dataset", "count", "--conv", "I2GNN", "--target",
              "triangle", "--hiddim", "128", "--num_layer", "5", "--bs",
              "64", "--lr", "3.4e-3", "--cosT", "26", "--minlr", "2.03e-5",
              "--wd", "3.7e-2", "--K", "0.011", "--K2", "0.0073",
              "--normparam", "0.31"]
COUNT_EPOCHS = 2
# the CPU repeats this many of a subgraph conv's ten steps (PPGN-SS's plain
# K1 gathers several times NGNN's triples a contraction)
SUBGRAPH_CPU_STEPS = 2
# served predictions, card vs CPU, where SERVE_TOL is below the f32
# rounding of the configuration itself.  PPGN-SS: six layers of 2-FWL
# products of two MLP outputs; with the seed-0 weights that the card
# machine's PyTorch (2.11) draws, the CPU's own predictions move by 1.5e-4
# when every Linear sums in f64 and by 2.7e-4 when each sums its input
# halves apart (scripts/fast_mode_tolerances.py --runs SERVE-PPGN there;
# NGNN-SS moves by 1.9e-6), and the card's lay 2.2e-4 from the CPU's
# (H100); about twice the CPU's own largest movement
SERVE_TOLS = {"PPGN": 5e-4}
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
DENSE_CPU_STEPS = 2
DENSE_TRAIN_RTOL = 1e-3
# NGNN-DD 6x128 as runs/converged/NGNN_dense.json trains it (6 layers x
# 128, mlplayer 2, outlayer 4, npool sum, lpool mean, cpool mean,
# normparam 0.194, spdsampler hop 4, batch 128, lr 1e-2), with
# example/zinc_tpu.py's MLP settings; the same configuration in SD mode
# (MaModel(mode="SD"), aggr sum) and with bf16 compute (--bf16)
NGNN_DENSE = dict(num_layer=6, hiddim=128, npool="sum", lpool="mean",
                  cpool="mean", outlayer=4,
                  mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                       "normparam": 0.194, "numlayer": 2, "tailact": True})
NGNN_DENSE_LR = 1e-2          # the converged run's learning rate
# each dense configuration's model and learning rate, by conv
DENSE_CFG = {"PPGN": (DENSE, DENSE_LR), "NGNN": (NGNN_DENSE, NGNN_DENSE_LR)}
# the subgraph convs in the dense modes (phase 24), 6x128 as the dense rows
# of scripts/converged_matrix.sh train them (spdsampler hop 4, batch 128,
# mlplayer 2, outlayer 4, and each conv's hps line: npool sum, its lpool,
# cpool mean, its normparam and lr), with example/zinc_tpu.py's MLP
# settings, in DD and in SD mode (MaModel(mode="SD"), aggr sum)
DENSE_SUBGRAPH_CONVS = ("SSWL", "DSSGNN", "GNNAK", "SUN")
DENSE_CFG.update({conv: (dict(num_layer=6, hiddim=128, npool="sum",
                              lpool=lpool, cpool="mean", outlayer=4,
                              mlp={"dp": 0.0, "norm": "bn", "act": "silu",
                                   "normparam": normparam, "numlayer": 2,
                                   "tailact": True}), lr)
                  for conv, lpool, normparam, lr in (
                      ("SSWL", "mean", 0.22, 9e-3),
                      ("DSSGNN", "sum", 0.31, 8.6e-3),
                      ("GNNAK", "sum", 0.31, 8.6e-3),
                      ("SUN", "sum", 0.57, 8.6e-3))})
# the tuple contractions a layer that K5 (or K1 on the SD fused route)
# takes, by conv: SSWL's within-subgraph (2, 1) and cross-subgraph (1, 1)
# products, one within-subgraph product for every other dense conv
DENSE_PRODUCTS = {"SSWL": 2}
# the NGNN dense phases hold the card against the CPU on batches of
# DENSE_CUT graphs, DENSE_CUT_STEPS steps of them (both sides on the same
# cut batches; the launch counts, the bitwise repeat and the timings take
# the full batches of 128): a 6x128 step at batch 128 takes tens of seconds
# on the CPU with the plain K5, and the run has four such configurations
DENSE_CUT = 32
DENSE_CUT_STEPS = 2
# per-step losses with bf16 compute, card vs CPU, on the cut batches: every
# activation is rounded to bf16, so a difference in the last f32 bits of a
# sum (other orders on the card: cuBLAS, the deterministic index sums)
# flips roundings, and AdamW's first step at lr 1e-2 turns each flipped
# small gradient into a parameter move of up to the lr.  The CPU run with
# every norm's sums reordered moves the two cut steps' losses by 9.5e-5
# and 3.9e-3 (scripts/fast_mode_tolerances.py --runs NGNNDD-bf16; the same
# reordering in f32 moves them by 3.2e-6, --runs NGNNDD-f32).  The card
# sums every product in another order (cuBLAS's bf16 GEMMs among them),
# not the norms' alone: its losses lay 1.3e-4 and 1.1e-2 from the CPU's
# on an H100 (the same bits in every run of both); about three times that
DENSE_BF16_TRAIN_RTOL = 3e-2
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
# the giant graph in the fast mode (overlapped_fused, set_fused_math(False),
# phase 20): the card's and the CPU's f32 values differ in their last bits
# (matmuls and sums in other orders), and an operand that lies within them
# of a bf16 rounding boundary rounds the other way on one side, moving its
# term by 2^-8; the CPU run with every layer's matmul summed in another
# order moves ten steps' losses by at most 2.1e-7 in this mode, against
# 1.0e-7 in the exact mode (scripts/fast_mode_tolerances.py --runs
# GIANT-f32,GIANT-f32fast), well inside GIANT_RTOL, which holds this phase
# too.  The CPU repeats the first three of the card's ten steps (about 3 s
# each at this size)
GIANT_FAST_CPU_STEPS = 3
# the ZINC entry point (phase 21): example/zinc_gpu.py's flags of the
# converged NGNN-SS row (runs/converged/NGNN_sparse.s0.json) on a cut
# training set, two epochs
ZINC_ARGS = ["--sparse", "--conv", "NGNN", "--fused", "--lr", "1e-2",
             "--minlr", "8.4e-5", "--wd", "4.9e-5", "--cosT", "26", "--K",
             "0.0049", "--K2", "4.33e-6", "--normparam", "0.194",
             "--mlplayer", "2", "--outlayer", "4"]
ZINC_NTRAIN = 1024
ZINC_EPOCHS = 2
# K5 vs its plain version on the card: the same rounded f32 products summed
# in the same order, so they should agree exactly; the tolerance of each
# output is K5_RTOL * sum |A[b,i,k,d] * X[b,k,j,d]| over its k.  The bf16
# variant widens its bf16 operands exactly, so the same holds for it
K5_RTOL = 1e-6

# The fast numerics mode (the JAX package's set_fused_math(False), its
# --fused runs) and bf16 compute.  Every K1 and K4 variant must equal its
# plain version bit for bit, as the f32 roles do (the same roundings to
# bf16, round to nearest even, at the same points).  Their gradients
# against autograd through the plain version: see check_k1 and check_k4
FAST_GRAD_RTOL = 2 ** -6
K4_FAST_GRAD_RTOL = 2 ** -5
# served predictions in fast mode, card vs CPU: where the card's and the
# CPU's f32 values differ in their last bits (sums in another order), a
# term whose operand lies that close to a bf16 rounding boundary rounds
# the other way and moves by one bf16 step, up to 2^-7 of itself; the CPU
# run with every norm's sums reordered moves a fast-mode step's loss by
# 2e-6 (scripts/fast_mode_tolerances.py); ten times SERVE_TOL leaves room
# for such flips through six layers.  Served in the fast mode with every
# Linear summed by halves or in f64, the CPU's own predictions move by
# 6.1e-4 / 8.7e-4 (NGNN-SS) and 5.7e-4 / 8.2e-4 (I2GNN-SS), and the card's
# lay 5.1e-4 and 4.7e-4 from the CPU's (H100, PyTorch 2.11; --runs
# SERVEFAST-NGNN,SERVEFAST-I2GNN there): I2GNN's rounding is no wider than
# NGNN's, and both sit under this limit
FAST_SERVE_TOL = 1e-3
# the CPU repeats this many of the bf16 model's ten steps
BF16_CPU_STEPS = 3
# per-step losses, card vs CPU, by configuration and variant: (CPU steps,
# max relative difference).  f32: TRAIN_RTOL.  Fast mode: the same; the
# flips above move ten steps' losses by at most 8.4e-5 on the CPU when
# every norm's sums are reordered (scripts/fast_mode_tolerances.py).
# bf16 compute: every activation is rounded to bf16 (up to 2^-8 of it),
# so differences in the last f32 bits flip roundings everywhere (1.1e-4
# over three steps in the same script), and the card's deterministic bf16
# segment sums accumulate in f32 where the CPU's round after each add:
# BF16_TRAIN_RTOL.  NGAT in fast mode: on the card its projections take
# bf16 inputs (as the JAX layer's do on its accelerator), on the CPU they
# stay f32 (as the JAX layer's do on the CPU), a difference of up to
# 2^-8 of each input; the same script, taking them on one side, gives
# 8.9e-4 over five steps: NGAT_FAST_TRAIN_RTOL
BF16_TRAIN_RTOL = 5e-3
NGAT_FAST_TRAIN_RTOL = 1e-2
# the variants held against their plain versions beside the f32 ones
FAST_VARIANTS = ((None, False), ("bf16", True), ("bf16", False))
# kernels that no main path of this script launches: K3's dA role in both
# modes (the giant step takes parameter gradients only, as JAX's does),
# and the bf16
# variants that keep exact products (a bf16 model in exact mode, which the
# JAX package runs without --fused; the smoke trains the bf16 model in the
# fast mode of --fused --bf16) and K4's bf16 variants (NGAT's attention
# runs in f32 whatever the compute dtype, as the JAX layer's does): each
# is held against its plain version in the kernels phase
UNLAUNCHED = {"window_spspmm_da_f32", "window_spspmm_da_f32fast",
              "spspmm_sum_fwd_bf16",
              "spspmm_sum_dx_bf16", "spspmm_sum_da_bf16",
              "seg_att_fwd_bf16", "seg_att_dw_bf16", "seg_att_dc_bf16",
              "seg_att_dv_bf16", "seg_att_fwd_bf16fast",
              "seg_att_dw_bf16fast", "seg_att_dc_bf16fast",
              "seg_att_dv_bf16fast"}
TRAIN_TOLS = {("NGNN", "f32"): (CPU_STEPS, TRAIN_RTOL),
              ("NGAT", "f32"): (NGAT_CPU_STEPS, TRAIN_RTOL),
              ("NGNN", "f32fast"): (CPU_STEPS, TRAIN_RTOL),
              ("NGNN", "bf16fast"): (BF16_CPU_STEPS, BF16_TRAIN_RTOL),
              ("NGAT", "f32fast"): (NGAT_CPU_STEPS, NGAT_FAST_TRAIN_RTOL),
              ("I2GNN", "f32"): (I2_CPU_STEPS, TRAIN_RTOL),
              ("I2GNN", "f32fast"): (I2_CPU_STEPS, TRAIN_RTOL),
              **{(conv, "f32"): (SUBGRAPH_CPU_STEPS, TRAIN_RTOL)
                 for conv in SUBGRAPH_CONVS}}


def sparse_keys(conv):
    """The precompute keys of the sparse configuration ``conv``, sorted as
    ``parse_precomputekey`` gives them."""
    return SPARSE_KEYS.get(conv, [KEY])


def sparse_sampler(conv):
    """The tuple sampler of the sparse configuration ``conv`` at hop 3:
    ``I2Sampler`` for I2GNN's 3-tuples, ``KhopSampler`` else."""
    from pygho_tpu_torch.hodata import I2Sampler, KhopSampler

    return partial(I2Sampler if conv == "I2GNN" else KhopSampler, hop=3)


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


def k1_bound(tuv, out_rows, D, sizes=(4, 4), ops=2):
    """The least time of one K1 role on the card: every referenced row of
    its two operands read once (``sizes``: their bytes a value, 2 for a
    bf16 operand), its index arrays and row pointer read once, every f32
    output row written once, against its ``ops`` operations a triple and
    channel (a product and a sum; in fast mode one more for each
    rounding to bf16).  Returns (ms, "bytes" or "operations", bytes,
    operations)."""
    import torch

    k = tuv.shape[1]
    u_read = int(torch.unique(tuv[1]).numel())
    v_read = int(torch.unique(tuv[2]).numel())
    nbytes = (u_read * sizes[0] + v_read * sizes[1] + out_rows * 4) * D \
        + k * 2 * 4 + (out_rows + 1) * 4
    flops = ops * k * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def mode_name(dtype=None, exact=True):
    """The variant suffix of a stored dtype and math mode: f32, f32fast,
    bf16 or bf16fast."""
    import torch

    bf16 = dtype == torch.bfloat16
    return ("bf16" if bf16 else "f32") + ("" if exact else "fast")


def rounded_ops(role_ops, dtype, exact, base=0):
    """Operations a triple and channel of a role: ``base`` arithmetic and,
    in fast mode, one rounding to bf16 for each f32 operand read (the
    role's operands other than the cotangent-side ones, which
    ``role_ops`` = (stored operands, f32 operands read, terms) counts)
    and each term."""
    import torch

    stored, f32_read, terms = role_ops
    if exact:
        return base
    return base + terms + f32_read + (0 if dtype == torch.bfloat16
                                      else stored)


def check_launch_failure(role, call):
    """A variant whose entry point refuses its launch (a chunk of 0
    triples: cudaErrorInvalidValue) raises, counts no launch and returns
    nothing: no other entry point or plain version takes over."""
    saved, before = role.CHUNK, role.launches
    role.CHUNK = 0
    try:
        call()
    except RuntimeError as err:
        if role.NAME not in str(err):
            raise AssertionError(f"{role.NAME}: the failure names another "
                                 f"kernel: {err}") from err
    else:
        raise AssertionError(f"{role.NAME}: a refused launch did not raise")
    finally:
        role.CHUNK = saved
    if role.launches != before:
        raise AssertionError(f"{role.NAME}: a refused launch was counted")
    print(f"{role.NAME}: a refused launch raises and counts nothing")


def check_k1(datas, dev, rng, flush, dtype=None, exact=True, key=KEY,
             edge_cases=True, batch_size=128, label=None):
    """K1's three roles, in the variant of operands stored as ``dtype``
    (f32 unless given) in the math mode ``exact``, at the shapes the
    precompute ``key`` gives one ``batch_size``-graph batch of ``datas``
    (NGNN's unless given; ``datas`` preprocessed with it) and, with
    ``edge_cases``, on edge cases, against their plain version on the
    card, and ``SpspmmSum``'s gradients against autograd through the
    plain version; for a fast or bf16 variant also a refused launch.
    ``label`` names the shape in the output.  Returns the roles' lines of
    the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata.loader import SpDataloader, backward_orders
    from pygho_tpu_torch.hodata.sp_data import parsekey
    from pygho_tpu_torch.kernels import spspmm_sum as k1

    dtype = dtype or torch.float32
    variant = {r: r.variant(dtype, exact) for r in k1.ROLES}
    batch = next(iter(SpDataloader(datas, batch_size, [key],
                                   backward=True)))
    nt, n_t = batch["tupleid"].shape[1], int(batch["num_tuples"])
    D = 128

    def rows(op):
        """An operand's padded and real rows: tuples or edges."""
        if op[0] == "X":
            return nt, n_t
        return batch["edge_index"].shape[1], int(batch["num_edges"])

    def operand(rows, real):
        x = np.zeros((rows, D), np.float32)
        x[:real] = rng.normal(size=(real, D))
        return torch.from_numpy(x).to(dev)

    def stored(role, L, R):
        """The role's operands as the variant reads them: the cotangent
        (dX's L, dA's R) in f32, the others in ``dtype``."""
        return (L if role is k1.DX else L.to(dtype),
                R if role is k1.DA else R.to(dtype))

    _, op1, _, op2, _ = parsekey(key)
    U, V, g = operand(*rows(op1)), operand(*rows(op2)), operand(nt, n_t)
    t = {name: torch.from_numpy(batch[f"{key}___{name}"]).to(dev)
         for name in ("acd", "rowptr", "acd_dx", "rowptr_dx", "acd_da",
                      "rowptr_da")}
    # each role's operands at the key's shapes: forward
    # out[a] += U[c] * V[d], dX dU[c] += g[a] * V[d], dA dV[d] += U[c] * g[a]
    main = {k1.FWD: (*stored(k1.FWD, U, V), t["acd"], t["rowptr"]),
            k1.DX: (*stored(k1.DX, g, V), t["acd_dx"], t["rowptr_dx"]),
            k1.DA: (*stored(k1.DA, U, g), t["acd_da"], t["rowptr_da"])}
    shape = label or ("main shape" if key == KEY else f"{key} shape")

    def compare(role, U, V, tuv, rowptr):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance); raises where an output row with no triples is not 0,
        or where the kernel's bits differ from the plain version's (both
        sum each row's rounded products in triple order)."""
        n = rowptr.shape[0] - 1
        out = k1.contract(role, U, V, tuv, rowptr, exact)
        ref = k1.contract_plain(U, V, tuv, n, exact)
        mag = k1.contract_plain(U.abs(), V.abs(), tuv, n, exact)
        sync()
        if out.numel() == 0:
            return 0.0, 0.0
        empty = (rowptr[1:] == rowptr[:-1])
        if bool((out[empty] != 0).any()):
            raise AssertionError(f"{variant[role].NAME} wrote a non-zero "
                                 f"empty row")
        if not torch.equal(out, ref):
            raise AssertionError(f"{variant[role].NAME} is not bit for bit "
                                 f"equal to its plain version")
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()))

    errs = {}
    for role, args in main.items():
        err, ratio = compare(role, *args)
        errs[role] = err
        print(f"{variant[role].NAME} {shape}: {args[2].shape[1]} "
              f"triples, operands {tuple(args[0].shape)} and "
              f"{tuple(args[1].shape)}, out {(args[3].shape[0] - 1, D)}; bit "
              f"for bit equal to the plain version (max abs err {err:.3e}, "
              f"{ratio:.3f} of the tolerance {KERNEL_RTOL:g} * sum |terms|)")
        if not ratio <= 1.0:
            raise AssertionError(f"{variant[role].NAME} disagrees with its "
                                 f"plain version: {err}")

    if edge_cases:
        # edge cases, for every role: empty rows, one row with many
        # triples, a padded tail, D = 16, a D that is not a multiple of 4
        # and an unaligned left operand (both take the scalar loop), no
        # triples; short rows with a run of 130 empty rows mid-array, rows
        # of 33 and 120 triples over several chunks, 5 triples past a
        # multiple of 32 (every chunk size); and the backward orders of a
        # forward case, as the loader builds them
        def case(role, D, rows, u_rows, v_rows, out_rows, misalign=False):
            t_ = np.sort(rows).astype(np.int64)
            tuv = np.stack([t_, rng.integers(0, u_rows, t_.size),
                            rng.integers(0, v_rows, t_.size)]) \
                .astype(np.int32)
            rp = np.zeros(out_rows + 1, np.int32)
            rp[1:] = np.cumsum(np.bincount(t_, minlength=out_rows))
            Ut = torch.from_numpy(rng.normal(size=(u_rows, D))
                                  .astype(np.float32)).to(dev)
            Vt = torch.from_numpy(rng.normal(size=(v_rows, D))
                                  .astype(np.float32)).to(dev)
            Ut, Vt = stored(role, Ut, Vt)
            if misalign:
                flat = torch.empty(u_rows * D + 1, device=dev,
                                   dtype=Ut.dtype)[1:]
                Ut = flat.view(u_rows, D).copy_(Ut)
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
                print(f"{variant[role].NAME} edge case {name}: bit for bit "
                      f"equal (max abs err {e:.3e}, {r:.3f} of the tolerance)")
                if not r <= 1.0:
                    raise AssertionError(f"{variant[role].NAME} edge case "
                                         f"{name} disagrees: {e}")
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
        for role, args in ((k1.DX, (*stored(k1.DX, gc, Ac), *orders["dx"])),
                           (k1.DA, (*stored(k1.DA, Xc, gc), *orders["da"]))):
            e, r = compare(role, *args)
            print(f"{variant[role].NAME} edge case backward orders of the "
                  f"heavy case: bit for bit equal (max abs err {e:.3e}, "
                  f"{r:.3f} of the tolerance)")
            if not r <= 1.0:
                raise AssertionError(f"{variant[role].NAME} on backward "
                                     f"orders: {e}")

    # SpspmmSum's gradients on the card against autograd through the plain
    # version, for a random cotangent W.  Exact f32: the same rounded
    # products, KERNEL_RTOL.  Fast or bf16: the kernel rounds each term of
    # a gradient (fast) and stores the gradient in bf16 (bf16 operands),
    # where autograd through the plain version rounds the cotangent and
    # the whole sum instead.  A rounding to bf16 moves a value by at most
    # 2^-8 of it: each term on one side, the sum once or twice on the
    # other, at most 3 * 2^-8 of the sum of |terms|; FAST_GRAD_RTOL =
    # 2^-6 leaves room for the f32 sums' order
    W = operand(nt, n_t)
    rtol = KERNEL_RTOL if (dtype == torch.float32 and exact) \
        else FAST_GRAD_RTOL
    Us, Vs = main[k1.FWD][0], main[k1.FWD][1]
    bwd = (t["acd_dx"], t["rowptr_dx"], t["acd_da"], t["rowptr_da"])
    Uk, Vk = Us.clone().requires_grad_(), Vs.clone().requires_grad_()
    (k1.SpspmmSum.apply(Uk, Vk, t["acd"], t["rowptr"], bwd, exact) * W) \
        .sum().backward()
    Up, Vp = Us.clone().requires_grad_(), Vs.clone().requires_grad_()
    (k1.contract_plain(Up, Vp, t["acd"], nt, exact) * W).sum().backward()
    with torch.no_grad():
        mags = (k1.contract_plain(W.abs(), Vs.abs(), t["acd_dx"],
                                  Us.shape[0], exact),
                k1.contract_plain(Us.abs(), W.abs(), t["acd_da"],
                                  Vs.shape[0], exact))
    for what, got, ref, mag in (("grad_U", Uk.grad, Up.grad, mags[0]),
                                ("grad_V", Vk.grad, Vp.grad, mags[1])):
        if got.dtype != ref.dtype:
            raise AssertionError(f"SpspmmSum {what} is {got.dtype}")
        diff = (got.float() - ref.float()).abs()
        ratio = float((diff / (rtol * mag).clamp_min(1e-30)).max())
        print(f"SpspmmSum ({mode_name(dtype, exact)}, {shape}) {what} vs "
              f"autograd through the plain version: max abs err "
              f"{float(diff.max()):.3e}, {ratio:.3f} of the tolerance "
              f"{rtol:g} * sum |terms|")
        if not ratio <= 1.0:
            raise AssertionError(f"SpspmmSum {what} disagrees")

    if dev.type == "cuda" and not (dtype == torch.float32 and exact):
        for role, args in main.items():
            check_launch_failure(
                variant[role], lambda: k1.contract(role, *args, exact))

    report = []
    sizes = {k1.FWD: (2, 2), k1.DX: (4, 2), k1.DA: (2, 4)} \
        if dtype == torch.bfloat16 else {r: (4, 4) for r in k1.ROLES}
    # (stored operands, f32 operands read, terms) a triple
    reads = {k1.FWD: (2, 0, 1), k1.DX: (1, 1, 1), k1.DA: (1, 1, 1)}
    for role, args in main.items():
        name = variant[role].NAME
        tuv, rowptr = args[2], args[3]
        out_rows = rowptr.shape[0] - 1
        ms = time_ms(lambda: k1.contract(role, *args, exact), flush)
        # the plain version with atomic index_add_ (deterministic
        # algorithms off), and in the parity mode (sorted index_add_)
        torch.use_deterministic_algorithms(False)
        plain_ms = time_ms(lambda: k1.contract_plain(
            args[0], args[1], tuv, out_rows, exact), flush)
        torch.use_deterministic_algorithms(True)
        plain_det_ms = time_ms(
            lambda: k1.contract_plain(args[0], args[1], tuv, out_rows,
                                      exact), flush)
        # inputs left in L2: the card first spins in place (no memory
        # traffic), so the launch is queued before the start event is
        # reached and the time is the kernel's, not the host's
        warm_ms = time_ms(lambda: k1.contract(role, *args, exact),
                          lambda: torch.cuda._sleep(1_000_000))
        # host cost of one wrapper call: checks, ctypes call, enqueue
        sync()
        t0 = time.perf_counter()
        for _ in range(100):
            k1.contract(role, *args, exact)
        host_us = (time.perf_counter() - t0) / 100 * 1e6
        sync()
        bound_ms, bound_by, nbytes, flops = k1_bound(
            tuv, out_rows, D, sizes[role],
            rounded_ops(reads[role], dtype, exact, base=2))
        print(f"{name} {shape} timing (L2 flushed before each launch, "
              f"median of 30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(deterministic plain {plain_det_ms:.4f} ms); bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} "
              f"f32 operations at 67 TFLOP/s); kernel with its inputs "
              f"left in L2 {warm_ms:.4f} ms; host time of one wrapper call "
              f"{host_us:.1f} us")
        report.append({"name": name, "route": "cuda",
                       "source": variant[role].SOURCE,
                       "replaces": variant[role].REPLACES,
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


def sparse_model(conv, device, dtype=None):
    """The sparse configuration ``SPARSE[conv]``, weights from seed 0,
    computing in ``dtype`` (f32 unless given)."""
    from pygho_tpu_torch.models import make_sp_model

    return make_sp_model(conv, seed=0, device=device, dtype=dtype,
                         **copy.deepcopy(SPARSE[conv]))


def sparse_roles(conv, dtype=None, exact=True):
    """The kernel roles that ``conv``'s layers launch (K1's or K4's) in
    the variant of the model's compute dtype (NGAT's attention runs in f32
    whatever it is) and the math mode ``exact``, the forward first."""
    import torch

    from pygho_tpu_torch.kernels import KERNELS

    if conv == "NGAT":
        dtype = None
    bases = [mod for mod in KERNELS if mod.base is mod
             and mod.SOURCE.endswith(SPARSE_SOURCE[conv])]
    return [mod.variant(dtype or torch.float32, exact) for mod in bases]


@contextlib.contextmanager
def math_mode(exact):
    """``with math_mode(exact):`` runs its body in the math mode ``exact``
    (``set_fused_math``) and restores the mode before it."""
    from pygho_tpu_torch.kernels import get_fused_math, set_fused_math

    was = get_fused_math()
    set_fused_math(exact)
    try:
        yield
    finally:
        set_fused_math(was)


def serve(graphs, rng, dev, conv="NGNN"):
    """``conv``-SS 6x128 through SpPredictor on ``dev``, then on the CPU,
    in the math mode set (``set_fused_math``)."""
    import numpy as np
    import torch

    from pygho_tpu_torch.honn import parse_precomputekey
    from pygho_tpu_torch.kernels import KERNELS, get_fused_math
    from pygho_tpu_torch.models import SpPredictor

    exact = get_fused_math()
    model = sparse_model(conv, dev)
    keys = parse_precomputekey(model)
    if keys != sparse_keys(conv):
        raise AssertionError(f"unexpected precompute keys {keys}")
    sampler = sparse_sampler(conv)
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
    expected[sparse_roles(conv, exact=exact)[0].NAME] = \
        SPARSE[conv]["num_layer"] * len(keys) * n_batches
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
    tol = SERVE_TOLS.get(conv, SERVE_TOL) if exact else FAST_SERVE_TOL
    print(f"card vs CPU (plain versions): max abs difference {diff:.3e} "
          f"(tolerance {tol:g})")
    if not diff <= tol:
        raise AssertionError(f"card and CPU disagree by {diff}")

    # throughput, after the checks: raw graphs (host precompute included)
    # and preprocessed graphs (collation, transfer and forward)
    sync()
    t0 = time.perf_counter()
    predictor(graphs)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    predictor.preprocess(graphs)
    host_s = time.perf_counter() - t0
    print(f"host precompute of {len(graphs)} raw graphs "
          f"({sampler.func.__name__}, spspmm_ind for {keys}): {host_s:.3f} "
          f"s, {host_s / raw_s:.1%} of "
          f"the raw-graph serving wall time {raw_s:.3f} s")
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


def train_run(device, batches, steps, per_step=None, conv="NGNN",
              dtype=None):
    """``conv``-SS 6x128 from seed 0, computing in ``dtype``, ``steps``
    AdamW steps at lr 1e-3 on ``batches`` through the port's
    ``make_sparse_steps``, in the math mode set.  Returns the per-step
    losses and the model.  ``per_step(i)`` runs after each step."""
    from pygho_tpu_torch.models import make_optimizer, make_sparse_steps

    model = sparse_model(conv, device, dtype)
    model.train()
    opt = make_optimizer(model, TRAIN_LR)
    train_step, _ = make_sparse_steps()
    losses = []
    for i, batch in enumerate(batches[:steps]):
        losses.append(train_step(model, opt, batch))
        if per_step is not None:
            per_step(i)
    return [float(x) for x in losses], model


def training(card, dev, conv="NGNN", dtype=None):
    """``conv``-SS 6x128 trains on the card, computing in ``dtype`` in the
    math mode set (``set_fused_math``): launch counts per step, finite
    losses, two runs bitwise identical, the CPU run's losses within the
    mode's tolerance (:data:`TRAIN_TOLS`); then graphs/s trained, a
    per-step breakdown and the peak device memory.  Returns the launches
    of the first training run."""
    import torch

    from pygho_tpu_torch.hodata import (SpDataloader, Sppretransform,
                                        synthetic_zinc)
    from pygho_tpu_torch.kernels import KERNELS, get_fused_math

    exact = get_fused_math()

    t0 = time.perf_counter()
    keys = sparse_keys(conv)
    pre = Sppretransform(sparse_sampler(conv), [""], keys)
    datas = [pre(g) for g in synthetic_zinc("train", seed=SEED)]
    loader = SpDataloader(datas, 128, keys, shuffle=True, drop_last=True,
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
    losses, model = train_run(dev, batches, TRAIN_STEPS, read, conv, dtype)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"trained {TRAIN_STEPS} steps in {run_s:.3f} s; losses "
          f"{[f'{x:.6f}' for x in losses]}; kernel launches {launches}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB ({peak} bytes)")
    mine = {mod.NAME for mod in sparse_roles(conv, dtype, exact)}
    want = {mod.NAME: SPARSE[conv]["num_layer"] * len(keys)
            if mod.NAME in mine else 0 for mod in KERNELS}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    again, model2 = train_run(dev, batches, TRAIN_STEPS, conv=conv,
                              dtype=dtype)
    state, state2 = model.state_dict(), model2.state_dict()
    same = again == losses and all(torch.equal(state[k], state2[k])
                                   for k in state)
    print(f"second run from the same seed: losses and all {len(state)} "
          f"parameters and buffers bitwise identical: {same}")
    if not same:
        raise AssertionError(f"two runs differ: {losses} vs {again}")
    del model, model2, state, state2

    cpu_steps, tol = TRAIN_TOLS[(conv, mode_name(dtype, exact))]
    t0 = time.perf_counter()
    cpu_losses, _ = train_run("cpu", batches, cpu_steps, conv=conv,
                              dtype=dtype)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"card vs CPU (plain versions), the first {cpu_steps} steps in "
          f"{time.perf_counter() - t0:.3f} s on the CPU: max relative loss "
          f"difference {rel:.3e} (tolerance {tol:g}); CPU losses "
          f"{[f'{x:.6f}' for x in cpu_losses]}")
    if not rel <= tol:
        raise AssertionError(f"card and CPU losses differ by {rel}")

    train_timing(card, dev, datas, conv=conv, dtype=dtype,
                 what=f"{conv}-SS 6x128 ({mode_name(dtype, exact)})")
    print(f"{conv}-SS 6x128 ({mode_name(dtype, exact)}) training on "
          f"{card}: peak device memory {peak / 2 ** 30:.3f} GiB ({peak} "
          f"bytes) over the first run")
    return launches


def train_timing(card, dev, datas, reps=8, conv="NGNN", dtype=None,
                 what=None):
    """Prints graphs/s trained over one epoch of the loader (collation
    included, one sync at the end), then one step's breakdown: host
    collation, the copy to the card, forward+backward and the optimizer
    step (each synchronised; medians over ``reps`` steps), forward+backward
    between CUDA events, and a whole step between CUDA events."""
    from pygho_tpu_torch.hodata import SpDataloader
    from pygho_tpu_torch.hodata.sp_data import batch_to_sparse_dict
    from pygho_tpu_torch.models import (make_optimizer, make_sparse_steps,
                                        masked_l1_loss)

    model = sparse_model(conv, dev, dtype)
    model.train()
    opt = make_optimizer(model, TRAIN_LR)
    train_step, _ = make_sparse_steps()
    loader = SpDataloader(datas, 128, sparse_keys(conv), shuffle=True,
                          drop_last=True, seed=1, backward=True)
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
    what = what or f"{conv}-SS 6x128"
    print(f"{what} training on {card}: {gps:.1f} graphs/s trained "
          f"(one epoch of 8 steps, collation included)")
    print(f"one 128-graph training step (median of {reps}): host "
          f"collation {med['collation']:.3f} ms, copy to the card "
          f"{med['copy']:.3f} ms, forward+backward {med['fwd+bwd']:.3f} ms "
          f"host wall / {dev_ms:.3f} ms between CUDA events, optimizer "
          f"{med['optimizer']:.3f} ms; sum {sum(med.values()):.3f} ms; a "
          f"whole step on a collated batch (copy included) {step_ms:.3f} ms "
          f"between CUDA events")


def k5_bound(shape, sizes=(4, 4)):
    """The least time of one K5 role on the card: its two operands read
    once (``sizes``: their bytes a value, 2 for a bf16 operand) and its f32
    output written once, against its 2 * b * n^3 * d f32 operations.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    b, n, _, d = shape
    nbytes = (sizes[0] + sizes[1] + 4) * b * n * n * d
    flops = 2 * b * n ** 3 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def check_k5(datas, dev, rng, flush, dtype=None):
    """K5's three roles, in the variant of operands stored as ``dtype``
    (f32 unless given; with bf16 the cotangent ``g`` of dA and dX stays
    f32), at the dense path's shape and on edge cases, against their
    plain version on the card; the four ``mamamm`` dim variants; and
    ``ChannelwiseBmm``'s gradients against autograd through the plain
    version.  Returns the roles' lines of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.backend.mamamm import mamamm
    from pygho_tpu_torch.backend.matensor import MaskedTensor
    from pygho_tpu_torch.hodata import MaDataloader
    from pygho_tpu_torch.kernels import channelwise_bmm as k5

    dtype = dtype or torch.float32
    rounded = dtype != torch.float32
    batch = next(iter(MaDataloader(datas, 128)))
    mask = torch.from_numpy(batch["X_mask"]).to(dev)
    shape = tuple(mask.shape) + (DENSE["hiddim"],)

    def operand(shape, mask=None, dt=dtype):
        """Normal values stored as ``dt``, zero off ``mask`` as
        ``mamamm`` fills them."""
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev)
        x = x if mask is None else torch.where(mask[..., None], x, 0.0)
        return x.to(dt)

    def role_args(A, X, g):
        """Each role's operands as ``ChannelwiseBmm`` passes them, the
        transposes as strided views: forward (A, X), dA (g, X^T), dX
        (A^T, g)."""
        return {k5.FWD: (A, X), k5.DA: (g, X.transpose(1, 2)),
                k5.DX: (A.transpose(1, 2), g)}

    def operands(shape, mask=None):
        return role_args(operand(shape, mask), operand(shape, mask),
                         operand(shape, mask, torch.float32))

    def compare(role, A, X):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance K5_RTOL * sum |terms|, bitwise equal)."""
        out = k5.cw_bmm(role, A, X)
        ref = k5.cw_bmm_plain(A, X)
        mag = k5.cw_bmm_plain(A.abs(), X.abs())
        sync()
        if tuple(out.shape) != tuple(A.shape) or not out.is_contiguous() \
                or out.dtype != torch.float32:
            raise AssertionError(f"{role.NAME} gave {tuple(out.shape)} "
                                 f"{out.dtype}")
        return measure(out, ref, mag)

    def measure(out, ref, mag, bf16_out=False):
        """Where ``bf16_out``, the output is rounded to bf16 after its
        sum and may lie one bf16 step (at most 2^-7 of it) more away."""
        diff = (out.float() - ref.float()).abs()
        allow = K5_RTOL * mag
        if bf16_out:
            allow = allow + ref.float().abs() * 2.0 ** -7
        return (float(diff.max()),
                float((diff / allow.clamp_min(1e-30)).max()),
                bool(torch.equal(out, ref)))

    def held(what, err, ratio, same, bf16_out=False):
        step = " + one bf16 step (2^-7 of the value)" if bf16_out else ""
        print(f"{what}: max abs err {err:.3e}, {ratio:.3f} of the tolerance "
              f"{K5_RTOL:g} * sum |terms|{step}; bitwise equal to the plain "
              f"version: {same}")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    variant = {role: role.variant(dtype, True) for role in k5.ROLES}
    main = operands(shape, mask)
    A, X = main[k5.FWD]
    errs = {}
    for role, args in main.items():
        errs[role], ratio, same = compare(role, *args)
        held(f"{variant[role].NAME} main shape {shape}", errs[role], ratio,
             same)

    # edge cases, for every role: n = 1; n (37, 33) not a multiple of the
    # 32 x 32 tile of (i, j) or of the 4 values of k a stage; d (13, 200)
    # not a multiple of the 16 channels of a block (d = 13 also not of the
    # 4 of a 16-byte copy: the scalar path); a batch whose first graph is
    # all masked
    for name, shp in (("n=1", (4, 1, 1, 128)),
                      ("n=37", (3, 37, 37, 128)),
                      ("d=13", (5, 20, 20, 13)),
                      ("n=33, d=200", (2, 33, 33, 200))):
        for role, args in operands(shp).items():
            held(f"{variant[role].NAME} edge case {name} {shp}",
                 *compare(role, *args))
    empty = mask[:6].clone()
    empty[0] = False
    for role, args in operands(tuple(empty.shape) + (128,), empty).items():
        held(f"{variant[role].NAME} edge case all-masked graph",
             *compare(role, *args))
        if bool((k5.cw_bmm(role, *args)[0] != 0).any()):
            raise AssertionError(f"{variant[role].NAME}: an all-masked "
                                 f"graph gave a non-zero output")

    # mamamm's four (dim1, dim2) variants, each brought to the kernel's
    # (2, 1) contraction through strided views; the result in the
    # operands' dtype
    ma = MaskedTensor(operand(tuple(empty.shape) + (128,)), empty)
    mb = MaskedTensor(operand(tuple(empty.shape) + (128,)), mask[6:12])
    for dim1, dim2 in ((2, 1), (1, 1), (2, 2), (1, 2)):
        with torch.no_grad():
            out = mamamm(ma, dim1, mb, dim2, empty).data
            fa, fb = ma.fill_masked(0.0), mb.fill_masked(0.0)
            fa = fa if dim1 == 2 else fa.transpose(1, 2)
            fb = fb if dim2 == 1 else fb.transpose(1, 2)
            ref = k5.cw_bmm_plain(fa, fb).to(dtype)
            mag = k5.cw_bmm_plain(fa.abs(), fb.abs())
        held(f"mamamm (dim1, dim2) = ({dim1}, {dim2}) through "
             f"{variant[k5.FWD].NAME}", *measure(out, ref, mag))

    # ChannelwiseBmm's gradients against autograd through the plain version
    # (in bf16 each returned in its operand's dtype, so rounded after sums
    # in another order)
    W = operand(shape, mask, torch.float32)
    Ak, Xk = A.clone().requires_grad_(), X.clone().requires_grad_()
    (k5.ChannelwiseBmm.apply(Ak, Xk) * W).sum().backward()
    Ap, Xp = A.clone().requires_grad_(), X.clone().requires_grad_()
    (k5.cw_bmm_plain(Ap, Xp) * W).sum().backward()
    with torch.no_grad():
        mags = (k5.cw_bmm_plain(W.abs(), X.abs().transpose(1, 2)),
                k5.cw_bmm_plain(A.abs().transpose(1, 2), W.abs()))
    for what, got, ref, mag in (("grad_A", Ak.grad, Ap.grad, mags[0]),
                                ("grad_X", Xk.grad, Xp.grad, mags[1])):
        if got.dtype != dtype:
            raise AssertionError(f"ChannelwiseBmm {what} is {got.dtype}")
        held(f"ChannelwiseBmm ({mode_name(dtype)}) {what} vs autograd "
             f"through the plain version", *measure(got, ref, mag, rounded),
             rounded)
    del Ak, Xk, Ap, Xp, W, mags

    report = []
    size = 2 if rounded else 4
    sizes = {k5.FWD: (size, size), k5.DA: (4, size), k5.DX: (size, 4)}
    for role, args in main.items():
        name = variant[role].NAME
        bound_ms, bound_by, nbytes, flops = k5_bound(shape, sizes[role])
        ms = time_ms(lambda: k5.cw_bmm(role, *args), flush)
        plain_ms = time_ms(lambda: k5.cw_bmm_plain(*args), flush)
        # the library's call for the same function on the same inputs, f32
        # without TF32 (set_parity_numerics); in bf16 on the operands
        # stored as bf16 (the f32 cotangent cast outside the timing)
        lib_args = tuple(a.to(dtype) for a in args)
        lib_ms = time_ms(lambda: torch.einsum("bikd,bkjd->bijd", *lib_args),
                         flush)
        del lib_args
        warm_ms = time_ms(lambda: k5.cw_bmm(role, *args),
                          lambda: torch.cuda._sleep(1_000_000))
        print(f"{name} timing (L2 flushed before each launch, median of "
              f"30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.einsum ({mode_name(dtype)} operands) {lib_ms:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, "
              f"{flops} f32 operations at 67 TFLOP/s); kernel with its "
              f"inputs left in L2 {warm_ms:.4f} ms")
        report.append({"name": name, "route": "cuda",
                       "source": variant[role].SOURCE,
                       "replaces": variant[role].REPLACES,
                       "launches": None, "max_abs_err": errs[role],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms})
    if not rounded:
        # the forward at SSWL's cross-subgraph layout (1, 1): mamamm hands
        # K5 the adjacency through its transposed strides, A[b,k,i,d] read
        # as (b, i, k, d); the same bytes and operations as at (2, 1)
        At = A.transpose(1, 2)
        err, ratio, same = compare(k5.FWD, At, X)
        held(f"{variant[k5.FWD].NAME} at the (1, 1) layout {shape}", err,
             ratio, same)
        cross_ms = time_ms(lambda: k5.cw_bmm(k5.FWD, At, X), flush)
        plain_ms = time_ms(lambda: k5.cw_bmm_plain(At, X), flush)
        lib_ms = time_ms(lambda: torch.einsum("bkid,bkjd->bijd", A, X),
                         flush)
        print(f"{variant[k5.FWD].NAME} at the (1, 1) layout (A read through "
              f"its transposed strides; L2 flushed before each launch, "
              f"median of 30): kernel {cross_ms:.4f} ms against "
              f"{report[0]['ms']:.4f} ms at (2, 1), plain {plain_ms:.4f} "
              f"ms, torch.einsum {lib_ms:.4f} ms; bound "
              f"{report[0]['bound_ms']:.4f} ms")
    return report


def k4_terms(role, ops, tuv, rows, M, gZ, goZ):
    """Each output of one K4 role's sum of |terms|, the scale of its
    rounding: the forward's out Σ α |a3[c]| (α = e / den), den itself
    and |M|; the gradient roles' sums of |ds| times their two factors,
    with |ds| <= e (|a3[c] gZ[a]| + |goZ[a]|), and dc's Σ e |gZ[a]|."""
    import torch

    from pygho_tpu_torch.kernels import segment_attention as k4

    a1, a3, aA, a2 = (x.float() for x in ops)
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


def k4_bound(role, tuv, rowptr, D, dtype=None, exact=True):
    """The least time of one K4 role on the card: every referenced row of
    each operand it reads once (forward: a2 by t, a1 and a3 by u, aA by v;
    dw: a2, M, gZ, goZ by t, a1 and a3 by u, aA by v; dc: a1 and a3 by t,
    a2, M, gZ, goZ by u, aA by v; dv: aA by t, a1 and a3 by u, a2, M, gZ,
    goZ by v), a1, a3, aA and a2 at the bytes of ``dtype`` (f32 unless
    given) and M, gZ, goZ in f32, its index arrays and row pointer once,
    and every f32 output written once, against its f32 operations (an exp
    counted as one): per triple and channel 8 in the forward (and a
    division per output), 10 in dw and dv, 12 in dc, and in fast mode one
    more for each rounding to bf16 of an f32 operand read and of each
    term.  Returns (ms, "bytes" or "operations", bytes, operations)."""
    import torch

    from pygho_tpu_torch.kernels import segment_attention as k4

    k = tuv.shape[1]
    out_rows = rowptr.shape[0] - 1
    t_read = int((rowptr[1:] > rowptr[:-1]).sum())
    u_read = int(torch.unique(tuv[1]).numel())
    v_read = int(torch.unique(tuv[2]).numel())
    size = 2 if dtype == torch.bfloat16 else 4
    # (stored rows, f32 rows) read by t, by u and by v; outputs; operations
    per_t, per_u, per_v, n_out, ops = {
        k4.FWD: ((1, 0), (2, 0), (1, 0), 3, 8),
        k4.DW: ((1, 3), (2, 0), (1, 0), 1, 10),
        k4.DC: ((2, 0), (1, 3), (1, 0), 2, 12),
        k4.DV: ((1, 0), (2, 0), (1, 3), 1, 10)}[role]
    stored = t_read * per_t[0] + u_read * per_u[0] + v_read * per_v[0]
    f32_rows = t_read * per_t[1] + u_read * per_u[1] + v_read * per_v[1] \
        + out_rows * n_out
    nbytes = (stored * size + f32_rows * 4) * D + k * 2 * 4 \
        + (out_rows + 1) * 4
    # fast mode: (stored operands, f32 operands rounded, terms) a triple
    reads = {k4.FWD: (4, 0, 2), k4.DW: (4, 2, 1), k4.DC: (4, 2, 2),
             k4.DV: (4, 2, 1)}[role]
    ops = rounded_ops(reads, dtype, exact, base=ops)
    flops = ops * k * D + (out_rows * D if role is k4.FWD else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def k4_grad_scales(ops, t, nt, ne, W):
    """The scale of each gradient of ``SegmentAttention`` for cotangent W,
    from the exact-mode values: each gradient's sum over its triples of
    |terms|, with |ds| taken as e |gZ| (|a3| + S) where S is the row's sum
    of alpha |a3|, which covers the cancellation in out and in
    a3 gZ - goZ.  Returns {grad name: scale}."""
    import torch

    from pygho_tpu_torch.kernels import segment_attention as k4

    a1, a3, aA, a2 = (x.float() for x in ops)
    a, c, d = t["acd"].long()
    out, den, M = k4.attention_plain(k4.FWD, a1, a3, aA, a2, t["acd"], nt)
    S = k4.attention_plain(k4.FWD, a1, a3.abs(), aA, a2, t["acd"], nt)[0]
    gZ, _ = k4.softmax_cotangents(W, out, den)
    e = torch.exp((a1[c] * aA[d]) * a2[a] - M[a])
    ads = e * gZ[a].abs() * (a3[c].abs() + S[a])

    def ssum(x, i, n):
        return torch.zeros(n, x.shape[1], device=x.device).index_add_(0, i, x)

    return {"grad_a1": ssum(ads * aA[d].abs() * a2[a].abs(), c, nt),
            "grad_a3": ssum(e * gZ[a].abs(), c, nt),
            "grad_aA": ssum(ads * a1[c].abs() * a2[a].abs(), d, ne),
            "grad_a2": ssum(ads * a1[c].abs() * aA[d].abs(), a, nt)}


def check_k4(datas, dev, rng, flush, dtype=None, exact=True):
    """K4's four roles, in the variant of a1, a3, aA and a2 stored as
    ``dtype`` (f32 unless given) in the math mode ``exact``, at the NGAT
    path's shapes and on edge cases, against their plain version on the
    card, and ``SegmentAttention``'s gradients against autograd through
    the plain forward; for a fast or bf16 variant also a refused launch.
    Returns the roles' lines of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.hodata.loader import (SpDataloader,
                                               backward_orders, row_pointer)
    from pygho_tpu_torch.kernels import segment_attention as k4

    dtype = dtype or torch.float32
    variant = {r: r.variant(dtype, exact) for r in k4.ROLES}
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
                                         rowptr.shape[0] - 1, exact=exact)
        return (M, *k4.softmax_cotangents(g, out, den))

    def compare(role, ops, tuv, rowptr, M=None, gZ=None, goZ=None):
        """Kernel vs plain version: (max abs error, max error over its
        tolerance), over every output of the role; raises on a value that
        is not finite, or where the kernel's bits differ from the plain
        version's (the same rounded steps, each row summed in triple
        order)."""
        rows = rowptr.shape[0] - 1
        got = k4.attend(role, *ops, tuv, rowptr, M, gZ, goZ, exact)
        ref = k4.attention_plain(role, *ops, tuv, rows, M, gZ, goZ, exact)
        mags = k4_terms(role, ops, tuv, rows, M, gZ, goZ)
        sync()
        err = ratio = 0.0
        for x, r, mag in zip(got, ref, mags):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{variant[role].NAME} gave a value "
                                     f"that is not finite")
            if x.numel() == 0:
                continue
            if not torch.equal(x, r):
                raise AssertionError(f"{variant[role].NAME} is not bit for "
                                     f"bit equal to its plain version")
            diff = (x - r).abs()
            err = max(err, float(diff.max()))
            ratio = max(ratio, float(
                (diff / (ATT_RTOL * mag).clamp_min(1e-30)).max()))
        return err, ratio

    def held(what, err, ratio, bitwise=False, rtol=ATT_RTOL):
        print(f"{what}: {'bit for bit equal, ' if bitwise else ''}max abs "
              f"err {err:.3e}, {ratio:.3f} of the tolerance {rtol:g} * "
              f"sum |terms|")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    ops = tuple(x.to(dtype) for x in (operand(nt, n_t), operand(nt, n_t),
                                      operand(ne, n_e), operand(nt, n_t)))
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
        held(f"{variant[role].NAME} main shape: {args[0].shape[1]} triples, "
             f"a1 {tuple(ops[0].shape)}, aA {tuple(ops[2].shape)}, out rows "
             f"{args[1].shape[0] - 1}", errs[role], ratio, True)

    # edge cases, for every role: empty rows, a row of one triple and one
    # of 2,000 (its backward orders spread it over many rows); D = 13 and
    # an a1 one value off alignment (both take the scalar loop); scores
    # scaled 3x, where the TPU kernel's bound shift flushes; and short rows
    # with a run of 130 empty rows mid-array, rows of 9, 33 and 120
    # triples over several chunks (the forward walks them twice) and 5
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
            ("a1 off alignment (scalar loop)", heavy, 128, 1.0, True),
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
                                 .astype(np.float32)).to(dev).to(dtype)
                for n in (x_rows, x_rows, e_rows, x_rows)]
        if misalign:
            flat = torch.empty(x_rows * Dc + 1, device=dev, dtype=dtype)[1:]
            eops[0] = flat.view(x_rows, Dc).copy_(eops[0])
        g = torch.from_numpy(rng.normal(size=(x_rows, Dc))
                             .astype(np.float32)).to(dev)
        egrads = grad_inputs(eops, e_acd, e_rp, g)
        cases = {k4.FWD: (e_acd, e_rp), k4.DW: (e_acd, e_rp, *egrads),
                 k4.DC: (*orders["dx"], *egrads),
                 k4.DV: (*orders["da"], *egrads)}
        for role, args in cases.items():
            held(f"{variant[role].NAME} edge case {name}",
                 *compare(role, eops, *args), True)
        if scale != 1.0:
            # where the TPU kernel's shift |a2[a]| max|a1| max|aA| lies
            # more than 60 nats above the row's maximum, its denominator
            # falls under its floor and the entry comes out 0
            M = egrads[0]
            f = [x.float() for x in eops]
            over = f[3].abs() * (f[0].abs().amax(0)
                                 * f[2].abs().amax(0)) - M
            live = (e_rp[1:] > e_rp[:-1])[:, None].expand_as(M)
            print(f"  scaled 3x: {int((over[live] > 60).sum())} of "
                  f"{int(live.sum())} live (row, channel) entries lie more "
                  f"than 60 nats under the TPU kernel's shift; every "
                  f"output here is finite")

    # SegmentAttention's gradients on the card against autograd through the
    # plain forward, for a random cotangent W.  Exact f32: the same rounded
    # steps, ATT_RTOL of k4_terms.  Fast or bf16: the kernel rounds gZ, goZ
    # and each term (fast) and stores the gradients in bf16 (bf16
    # operands), where autograd through the plain forward rounds the
    # cotangent of each rounded message and of each operand instead:
    # about eight roundings of at most 2^-8 between the two, 2^-5 of the
    # scale (k4_grad_scales, from the exact-mode values):
    # K4_FAST_GRAD_RTOL
    W = operand(nt, n_t)
    bwd = (t["acd_dx"], t["rowptr_dx"], t["acd_da"], t["rowptr_da"])
    ks = [x.clone().requires_grad_() for x in ops]
    (k4.SegmentAttention.apply(*ks, t["acd"], t["rowptr"], bwd, exact)
     * W).sum().backward()
    ps = [x.clone().requires_grad_() for x in ops]
    (k4.attention_plain(k4.FWD, *ps, t["acd"], nt, exact=exact)[0] * W) \
        .sum().backward()
    with torch.no_grad():
        if dtype == torch.float32 and exact:
            wgrads = grad_inputs(ops, t["acd"], t["rowptr"], W)
            dc = k4_terms(k4.DC, ops, t["acd_dx"], nt, *wgrads)
            mags = {"grad_a1": dc[0], "grad_a3": dc[1],
                    "grad_aA": k4_terms(k4.DV, ops, t["acd_da"], ne,
                                        *wgrads)[0],
                    "grad_a2": k4_terms(k4.DW, ops, t["acd"], nt,
                                        *wgrads)[0]}
            rtol = ATT_RTOL
        else:
            mags = k4_grad_scales(ops, t, nt, ne, W)
            rtol = K4_FAST_GRAD_RTOL
    for (what, mag), got, ref in zip(mags.items(), ks, ps):
        if got.grad.dtype != ref.grad.dtype:
            raise AssertionError(f"SegmentAttention {what} is "
                                 f"{got.grad.dtype}")
        diff = (got.grad.float() - ref.grad.float()).abs()
        held(f"SegmentAttention ({mode_name(dtype, exact)}) {what} vs "
             f"autograd through the plain forward", float(diff.max()),
             float((diff / (rtol * mag).clamp_min(1e-30)).max()),
             rtol=rtol)
    del ks, ps, W, mags

    if dev.type == "cuda" and not (dtype == torch.float32 and exact):
        for role, args in main.items():
            check_launch_failure(
                variant[role],
                lambda: k4.attend(role, *ops, *args, exact=exact))

    report = []
    for role, args in main.items():
        name = variant[role].NAME
        tuv, rowptr = args[0], args[1]
        ms = time_ms(lambda: k4.attend(role, *ops, *args, exact=exact),
                     flush)
        plain_ms = time_ms(lambda: k4.attention_plain(
            role, *ops, tuv, rowptr.shape[0] - 1, *args[2:], exact=exact),
            flush)
        warm_ms = time_ms(lambda: k4.attend(role, *ops, *args, exact=exact),
                          lambda: torch.cuda._sleep(1_000_000))
        bound_ms, bound_by, nbytes, flops = k4_bound(role, tuv, rowptr, D,
                                                     dtype, exact)
        print(f"{name} timing (L2 flushed before each launch, median "
              f"of 30): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} f32 "
              f"operations at 67 TFLOP/s); kernel with its inputs left in "
              f"L2 {warm_ms:.4f} ms")
        report.append({"name": name, "route": "cuda",
                       "source": variant[role].SOURCE,
                       "replaces": variant[role].REPLACES,
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


def check_k3(inst, dev, rng, flush, exact=True):
    """K3's three roles, in the variant of the math mode ``exact``, at the
    giant graph's shapes (hop-1 triples of the RCM-ordered 200x100
    community graph, D = 128) and on edge cases, bit for bit against their
    plain version on the card; ``WindowSpspmmSum``'s gradients, with both
    operands requiring grad, against autograd through the plain version;
    for the fast variant a refused launch; and the roles' times beside
    K1's three roles (the same variant) on the same triples and row
    pointers.  Returns the roles' lines of the report."""
    import numpy as np
    import torch

    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.kernels import window_spspmm as k3

    variant = {r: r.variant(torch.float32, exact) for r in k3.ROLES}
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
        not 0, or where the bits differ (both sum each row's rounded
        products in triple order)."""
        out = k3.contract(role, U, V, plan, exact)
        ref = k1.contract_plain(U, V, plan.tuv, plan.out_rows, exact)
        mag = k1.contract_plain(U.abs(), V.abs(), plan.tuv, plan.out_rows,
                                exact)
        sync()
        if out.numel() == 0:
            return 0.0, 0.0, True
        empty = torch.bincount(plan.tuv[0].long(),
                               minlength=plan.out_rows) == 0
        if bool((out[empty] != 0).any()):
            raise AssertionError(f"{variant[role].NAME} wrote a non-zero "
                                 f"empty row")
        if not torch.equal(out, ref):
            raise AssertionError(f"{variant[role].NAME} is not bit for bit "
                                 f"equal to its plain version")
        diff = (out - ref).abs()
        return (float(diff.max()),
                float((diff / (KERNEL_RTOL * mag).clamp_min(1e-30)).max()),
                bool(torch.equal(out, ref)))

    def held(what, err, ratio, same, rtol=KERNEL_RTOL):
        print(f"{what}: max abs err {err:.3e}, {ratio:.3f} of the tolerance "
              f"{rtol:g} * sum |terms|; bitwise equal to the plain "
              f"version: {same}")
        if not ratio <= 1.0:
            raise AssertionError(f"{what} disagrees with the plain version: "
                                 f"{err}")

    errs = {}
    for role, args in main.items():
        errs[role], ratio, same = compare(role, *args)
        held(f"{variant[role].NAME} giant shape ({args[2].tuv.shape[1]} "
             f"triples, "
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
            held(f"{variant[role].NAME} edge case {name} ({plan.n_warps} "
                 f"warps)",
                 *compare(role, Uc, Vc, plan.to(dev)))

    # WindowSpspmmSum's gradients against autograd through the plain
    # version, both operands requiring grad (so the dA role runs); in fast
    # mode the kernel rounds the cotangent and each term, autograd through
    # the plain version neither: FAST_GRAD_RTOL, as for K1
    rtol = KERNEL_RTOL if exact else FAST_GRAD_RTOL
    W = operand(nnz, n_t)
    for mod in k3.ROLES + k3.FAST_ROLES:
        mod.launches = 0
    Xk, Ak = X.clone().requires_grad_(), A.clone().requires_grad_()
    (k3.WindowSpspmmSum.apply(Xk, Ak, plans, exact) * W).sum().backward()
    ran = {mod.NAME: mod.launches for mod in k3.ROLES + k3.FAST_ROLES}
    want = {mod.NAME: int(mod in variant.values())
            for mod in k3.ROLES + k3.FAST_ROLES}
    if ran != want:
        raise AssertionError(f"WindowSpspmmSum launched {ran}")
    Xp, Ap = X.clone().requires_grad_(), A.clone().requires_grad_()
    (k1.contract_plain(Xp, Ap, plans[0].tuv, nnz, exact) * W).sum() \
        .backward()
    with torch.no_grad():
        mags = (k1.contract_plain(W.abs(), A.abs(), plans[1].tuv, nnz,
                                  exact),
                k1.contract_plain(X.abs(), W.abs(), plans[2].tuv, ne,
                                  exact))
    for what, got, ref, mag in (("grad_X", Xk.grad, Xp.grad, mags[0]),
                                ("grad_A", Ak.grad, Ap.grad, mags[1])):
        diff = (got - ref).abs()
        ratio = float((diff / (rtol * mag).clamp_min(1e-30)).max())
        held(f"WindowSpspmmSum ({mode_name(None, exact)}) {what} vs autograd "
             f"through the plain version", float(diff.max()), ratio,
             bool(torch.equal(got, ref)), rtol)

    if dev.type == "cuda" and not exact:
        # a plan with no warps: the entry point refuses the launch
        for role, (U, V, plan) in main.items():
            bad = dataclasses.replace(plan, warp_row=plan.warp_row[:1])
            before = variant[role].launches
            try:
                k3.contract(role, U, V, bad, exact)
            except RuntimeError as err:
                if variant[role].NAME not in str(err):
                    raise AssertionError(f"the failure names another "
                                         f"kernel: {err}") from err
            else:
                raise AssertionError(f"{variant[role].NAME}: a refused "
                                     f"launch did not raise")
            if variant[role].launches != before:
                raise AssertionError(f"{variant[role].NAME}: a refused "
                                     f"launch was counted")
            print(f"{variant[role].NAME}: a refused launch raises and "
                  f"counts nothing")

    # K1's three roles on the same triples and row pointers: the yardstick
    report, k1_lines = [], []
    # (stored operands, f32 operands read, terms) a triple: all f32
    reads = {k3.FWD: (2, 0, 1), k3.DX: (1, 1, 1), k3.DA: (1, 1, 1)}
    for role, r1 in zip(k3.ROLES, k1.ROLES):
        U, V, plan = main[role]
        name, name1 = variant[role].NAME, r1.variant(torch.float32,
                                                     exact).NAME
        k1_args = (U, V, plan.tuv, plan.rowptr)
        k1_out = k1.contract(r1, *k1_args, exact)
        k1_same = bool(torch.equal(k1_out,
                                   k3.contract(role, U, V, plan, exact)))
        ms = time_ms(lambda: k3.contract(role, U, V, plan, exact), flush)
        k1_ms = time_ms(lambda: k1.contract(r1, *k1_args, exact), flush)
        torch.use_deterministic_algorithms(False)
        plain_ms = time_ms(lambda: k1.contract_plain(
            U, V, plan.tuv, plan.out_rows, exact), flush)
        torch.use_deterministic_algorithms(True)
        warm_ms = time_ms(lambda: k3.contract(role, U, V, plan, exact),
                          lambda: torch.cuda._sleep(1_000_000))
        k1_warm_ms = time_ms(lambda: k1.contract(r1, *k1_args, exact),
                             lambda: torch.cuda._sleep(1_000_000))
        bound_ms, bound_by, nbytes, flops = k1_bound(
            plan.tuv, plan.out_rows, D,
            ops=rounded_ops(reads[role], torch.float32, exact, base=2))
        print(f"{name} timing at the giant shape (L2 flushed before "
              f"each launch, median of 30): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; K1 {name1} on the same triples "
              f"{k1_ms:.4f} ms (bitwise equal to K3: {k1_same}); bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s, {flops} f32 "
              f"operations at 67 TFLOP/s); inputs left in L2: K3 "
              f"{warm_ms:.4f} ms, K1 {k1_warm_ms:.4f} ms")
        k1_lines.append({"name": name1, "ms": k1_ms, "warm_ms": k1_warm_ms,
                         "k3": name, "k3_ms": ms, "k3_warm_ms": warm_ms,
                         "bound_ms": bound_ms, "bitwise": k1_same})
        report.append({"name": name, "route": "cuda",
                       "source": variant[role].SOURCE,
                       "replaces": variant[role].REPLACES,
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


def train_giant(card, dev, inst, strategy="overlapped", exact=True):
    """The giant graph trains on the card through ``parallel/giant.py``
    under the JAX strategy ``strategy``, its steps built in the math mode
    ``exact``: three launches a step of K3's forward role and three of
    its dX role, in the mode's variant (fast only under
    ``overlapped_fused``), and nothing else, finite losses, two runs
    bitwise identical, the CPU's losses within GIANT_RTOL; then
    ms a step, the plan's host time and the peak device memory.  In fast
    mode also a step under ``overlapped`` with the same flag, which must
    launch the exact roles.  Returns the launches of the first run."""
    import torch

    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.kernels import window_spspmm as k3
    from pygho_tpu_torch.parallel import build_giant_graph_plan

    fast = not exact and strategy == "overlapped_fused"
    cpu_steps = GIANT_FAST_CPU_STEPS if fast else GIANT_CPU_STEPS
    name = f"giant graph ({strategy}, {mode_name(None, not fast)})"
    t0 = time.perf_counter()
    plan = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                  inst["nnz_pad"], inst["n"], 1,
                                  strategy=strategy,
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
    with math_mode(exact):
        losses, model, (step, Xv, Av, y) = giant_train_run(
            dev, inst, plan, GIANT_STEPS, read)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"{name}: trained {GIANT_STEPS} steps in {run_s:.3f} s (the first "
          f"includes moving the plan); losses {[f'{x:.7f}' for x in losses]}; "
          f"kernel launches {launches}; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes)")
    want = {mod.NAME: 0 for mod in KERNELS}
    for role in (k3.FWD, k3.DX):
        want[role.variant(torch.float32, not fast).NAME] = GIANT["num_layer"]
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    with math_mode(exact):
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

    if not exact:
        # the same flag under a strategy whose JAX contraction ignores it
        other = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                       inst["nnz_pad"], inst["n"], 1,
                                       strategy="overlapped",
                                       n_edge_rows=inst["Av"].shape[0])
        for mod in KERNELS:
            mod.launches = 0
        with math_mode(exact):
            giant_train_run(dev, inst, other, 1)
        sync()
        ran = {mod.NAME: mod.launches for mod in KERNELS if mod.launches}
        want_exact = {k3.FWD.NAME: GIANT["num_layer"],
                      k3.DX.NAME: GIANT["num_layer"]}
        print(f"one step under overlapped with the fast flag: launched "
              f"{ran} (the exact roles)")
        if ran != want_exact:
            raise AssertionError(f"overlapped under the fast flag launched "
                                 f"{ran}, expected {want_exact}")
        for mod in KERNELS:
            mod.launches = 0

    t0 = time.perf_counter()
    with math_mode(exact):
        cpu_losses, _, _ = giant_train_run("cpu", inst, plan, cpu_steps)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"card vs CPU (plain versions), the first {cpu_steps} steps "
          f"in {time.perf_counter() - t0:.3f} s on the CPU: max relative "
          f"loss difference {rel:.3e} (tolerance {GIANT_RTOL:g}); CPU losses "
          f"{[f'{x:.7f}' for x in cpu_losses]}")
    if not rel <= GIANT_RTOL:
        raise AssertionError(f"card and CPU losses differ by {rel}")
    print(f"{name} {GIANT['communities']}x{GIANT['csize']}, hiddim "
          f"{GIANT['hiddim']}, {GIANT['num_layer']} layers on {card}: "
          f"{step_ms:.3f} ms a step between CUDA events (median of 10); "
          f"plan {plan_s:.3f} s on the host; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB")
    return launches


def zinc_entry(card, dev):
    """``example/zinc_gpu.py``'s run in this process: NGNN-SS 6x128 with
    ``--fused`` (the converged row's flags, ``ZINC_ARGS``) on
    ``ZINC_NTRAIN`` synthetic training graphs for ``ZINC_EPOCHS`` epochs
    with val and test MAE, its records and caches in a temporary
    directory.  Checks: the K1 ``*_f32fast`` roles and no other kernel,
    dX and dA six times a training step; the jsonl records (padding, then
    an epoch and a telemetry record an epoch); finite losses and MAE; the
    converged record's keys (those of
    ``runs/converged/NGNN_sparse.s0.json``); and a checkpoint written
    after epoch 1 and restored, with the training loader's shuffle state
    and buckets as they were then, gives epoch 2's loss bit for bit.
    Returns the launches of the run."""
    import tempfile

    import torch

    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.kernels import spspmm_sum as k1
    from pygho_tpu_torch.utils import restore_checkpoint, save_checkpoint

    sys.path.insert(0, str(REPO / "example"))
    import zinc_gpu

    with open(REPO / "runs" / "converged" / "NGNN_sparse.s0.json") as f:
        row = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = zinc_gpu.parse_args(
            ZINC_ARGS + ["--ntrain", str(ZINC_NTRAIN), "--epochs",
                         str(ZINC_EPOCHS), "--cache-dir", str(tmp / "cache"),
                         "--log-dir", str(tmp / "logs"),
                         "--converged-record", str(tmp / "rec.json")])
        saved = {}

        def on_epoch(epoch, run):
            if epoch == 1:
                save_checkpoint(str(tmp / "ck"), run.model, run.opt, epoch)
                saved["rng"] = copy.deepcopy(run.loaders["train"].rng)
                saved["buckets"] = copy.deepcopy(
                    run.loaders["train"].buckets)
            saved["run"] = run

        sync()
        for mod in KERNELS:
            mod.launches = 0
        t0 = time.perf_counter()
        rec = zinc_gpu.run_once(args, 0, on_epoch)
        sync()
        run_s = time.perf_counter() - t0
        launches = {mod.NAME: mod.launches for mod in KERNELS}
        run = saved["run"]
        steps = ZINC_EPOCHS * len(run.loaders["train"])
        ran = {k: v for k, v in launches.items() if v}
        fast = {r.variant(torch.float32, False).NAME for r in k1.ROLES}
        print(f"zinc_gpu.py NGNN-SS 6x128 --fused, {ZINC_NTRAIN} training "
              f"graphs, {ZINC_EPOCHS} epochs ({steps} steps) in "
              f"{run_s:.3f} s, preprocessing included; epoch times "
              f"{[f'{x:.3f}' for x in run.epoch_times]} s; losses "
              f"{run.losses}; best val MAE {rec['best_val_mae']} at epoch "
              f"{rec['best_val_epoch']}, test MAE "
              f"{rec['tst_mae_at_best_val']}; kernel launches {ran}")
        if set(ran) != fast:
            raise AssertionError(f"the ZINC run launched {ran}, expected "
                                 f"the K1 roles {sorted(fast)}")
        for role in (k1.DX, k1.DA):
            name = role.variant(torch.float32, False).NAME
            if ran[name] != 6 * steps:
                raise AssertionError(f"{name} launched {ran[name]} times "
                                     f"in {steps} steps")
        if not all(math.isfinite(x) for x in run.losses) or not all(
                rec[k] is not None and math.isfinite(rec[k])
                for k in ("best_val_mae", "tst_mae_at_best_val")):
            raise AssertionError(f"non-finite loss or MAE: {run.losses}, "
                                 f"{rec}")
        with open(tmp / "logs" / "zinc_gpu_sp_NGNN_h3_r0.jsonl") as f:
            recs = [json.loads(line) for line in f]
        types = [r["type"] for r in recs]
        if types != ["padding"] + ["epoch", "telemetry"] * ZINC_EPOCHS:
            raise AssertionError(f"jsonl records {types}")
        if [r["trn_loss"] for r in recs if r["type"] == "epoch"] \
                != run.losses:
            raise AssertionError("the epoch records do not hold the losses")
        with open(tmp / "rec.json") as f:
            written = json.load(f)
        if set(written) - {"device"} != set(row) \
                or set(written["hps"]) != set(row["hps"]):
            raise AssertionError(f"the converged record's keys "
                                 f"{sorted(written)} are not the row's")
        print(f"jsonl records {types}; converged record keys as "
              f"runs/converged/NGNN_sparse.s0.json, with device "
              f"{written.get('device')}")

        # epoch 2 again, from the checkpoint of epoch 1
        with math_mode(False):
            if restore_checkpoint(str(tmp / "ck"), run.model, run.opt) != 1:
                raise AssertionError("the checkpoint is not epoch 1's")
            loader = run.loaders["train"]
            loader.rng = saved["rng"]
            loader.buckets = saved["buckets"]
            again = run.train_epoch()
        sync()
        print(f"epoch 2 from the checkpoint of epoch 1: loss {again!r} "
              f"against {run.losses[1]!r}: bitwise identical "
              f"{again == run.losses[1]}")
        if again != run.losses[1]:
            raise AssertionError("the restored run's epoch 2 differs")
        trained = len(run.loaders["train"]) * args.bs
        print(f"ZINC entry point (NGNN-SS 6x128, f32fast) on {card}: "
              f"{trained / run.epoch_times[-1]:.1f} graphs/s trained in "
              f"epoch {ZINC_EPOCHS} ({run.epoch_times[-1]:.3f} s for "
              f"{trained} graphs, collation included)")
        del run, saved
    return launches


def count_entry(card, dev):
    """``example/expressivity_gpu.py``'s count task in this process: I2GNN
    5x128 with the tuned flags (``COUNT_ARGS``) for ``COUNT_EPOCHS``
    epochs, its cache and records in a temporary directory.  Checks: K1's
    f32 forward and dX roles and no other kernel (the count graphs have no
    edge features, so the adjacency has no values and no dA role runs),
    five dX launches a training step and five forward launches a training
    step and validation batch; finite losses and validation MAE; an epoch
    record a epoch.  Returns the launches of the run."""
    import tempfile

    import torch

    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.kernels import spspmm_sum as k1

    sys.path.insert(0, str(REPO / "example"))
    import expressivity_gpu

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        args = expressivity_gpu.parse_args(
            COUNT_ARGS + ["--epochs", str(COUNT_EPOCHS), "--cache-dir",
                          str(tmp / "cache"), "--log-dir", str(tmp)])
        t0 = time.perf_counter()
        run = expressivity_gpu.CountRun(args)
        setup_s = time.perf_counter() - t0
        sync()
        for mod in KERNELS:
            mod.launches = 0
        t0 = time.perf_counter()
        rec = run.run()
        sync()
        run_s = time.perf_counter() - t0
        launches = {mod.NAME: mod.launches for mod in KERNELS}
        with open(tmp / "expr_gpu_count_triangle_I2GNN.jsonl") as f:
            lines = [json.loads(line) for line in f]
    ran = {k: v for k, v in launches.items() if v}
    layers = args.num_layer
    width = f"I2GNN {layers}x{args.hiddim}"
    steps = COUNT_EPOCHS * len(run.trn)
    fwd, dx = (r.variant(torch.float32, True).NAME for r in (k1.FWD, k1.DX))
    want = {fwd: layers * (steps + COUNT_EPOCHS * len(run.val)),
            dx: layers * steps}
    losses = [h["loss"] for h in run.history]
    print(f"expressivity_gpu.py count {width}, {len(run.trn.dataset)} "
          f"training and {len(run.val.dataset)} validation graphs, "
          f"{COUNT_EPOCHS} epochs ({steps} steps) in {run_s:.3f} s after a "
          f"set-up of {setup_s:.3f} s (preprocessing included); epoch times "
          f"{[round(h['secs'], 3) for h in run.history]} s; losses "
          f"{losses}; validation MAE {[h['mae'] for h in run.history]}, "
          f"best {rec['best_val_mae']} at epoch {rec['best_val_epoch']}; "
          f"kernel launches {ran}")
    if ran != want:
        raise AssertionError(f"the count run launched {ran}, expected "
                             f"{want}")
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(
            rec["best_val_mae"]):
        raise AssertionError(f"non-finite loss or MAE: {losses}, {rec}")
    if [(r["type"], r["epoch"]) for r in lines] != [
            ("epoch", e) for e in range(1, COUNT_EPOCHS + 1)]:
        raise AssertionError(f"jsonl records {lines}")
    trained = len(run.trn.dataset)
    print(f"count entry point ({width}, f32) on {card}: "
          f"{trained / run.history[-1]['secs']:.1f} graphs/s trained and "
          f"validated in epoch {COUNT_EPOCHS} "
          f"({run.history[-1]['secs']:.3f} s, collation included)")
    return launches


def dense_name(conv="PPGN", mode="DD", dtype=None, plans=False):
    """A dense path's name in the output: conv, mode, depth x width,
    variant and, in SD mode, the route of its contraction."""
    route = "" if mode == "DD" else (", fused route" if plans
                                     else ", densify route")
    cfg = DENSE_CFG[conv][0]
    return (f"{conv}-{mode} {cfg['num_layer']}x{cfg['hiddim']} "
            f"({mode_name(dtype)}{route})")


def dense_launch_count(conv):
    """The launches of each of a dense path's kernel roles in one forward
    (or one training step): a layer's contractions times the depth."""
    return DENSE_CFG[conv][0]["num_layer"] * DENSE_PRODUCTS.get(conv, 1)


def dense_model(device, conv="PPGN", mode="DD", dtype=None):
    """The dense configuration of ``conv`` (``DENSE_CFG``) in ``mode``,
    computing in ``dtype`` (f32 unless given), weights from seed 0."""
    from pygho_tpu_torch.models import make_ma_model

    return make_ma_model(conv, seed=0, device=device, mode=mode, dtype=dtype,
                         **copy.deepcopy(DENSE_CFG[conv][0]))


def dense_roles(conv, mode, dtype=None, plans=False):
    """The kernel roles that a dense path's layers launch,
    :func:`dense_launch_count` times a step each in training, the forward
    first: K5's (in the variant of ``dtype``), or K1's f32 roles on the SD
    mode's fused route."""
    import torch

    from pygho_tpu_torch.kernels import channelwise_bmm as k5
    from pygho_tpu_torch.kernels import spspmm_sum as k1

    if mode == "SD" and plans:
        return list(k1.ROLES)
    return [r.variant(dtype or torch.float32, True) for r in k5.ROLES]


def serve_dense(graphs, rng, dev, conv="PPGN", mode="DD"):
    """A dense configuration through MaPredictor on ``dev`` (the densify
    route in SD mode: the predictor builds no plans), then on the CPU:
    PPGN-DD on every request, the other paths on the 40-graph request in
    batches of DENSE_CUT."""
    import numpy as np

    from pygho_tpu_torch.hodata import spdsampler
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.models import MaPredictor

    model = dense_model(dev, conv, mode)
    sampler = partial(spdsampler, hop=DENSE_HOP)
    denseadj = mode == "DD"
    predictor = MaPredictor(model, sampler, batch_size=128,
                            denseadj=denseadj, device=dev)
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
    expected[dense_roles(conv, mode)[0].NAME] = \
        dense_launch_count(conv) * n_batches
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
    cut = conv != "PPGN"
    cpu = MaPredictor(copy.deepcopy(model).cpu(), sampler,
                      batch_size=DENSE_CUT if cut else 128,
                      denseadj=denseadj, device="cpu")
    cpu_part = cpu([datas[i] for i in subset])
    diff = float(np.abs(cpu_part - part).max())
    if not cut:
        diff = max(diff, float(np.abs(cpu(datas) - full).max()))
    print(f"card vs CPU (plain versions, {time.perf_counter() - t0:.3f} s "
          f"on the CPU{f', batches of {DENSE_CUT}' if cut else ''}): max "
          f"abs difference {diff:.3e} (tolerance {DENSE_SERVE_TOL:g})")
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


def dense_train_run(device, batches, steps, per_step=None, conv="PPGN",
                    mode="DD", dtype=None):
    """A dense configuration from seed 0, ``steps`` AdamW steps at
    its learning rate on ``batches`` through the port's
    ``make_dense_steps``.  Returns the per-step losses and the model."""
    from pygho_tpu_torch.models import make_dense_steps, make_optimizer

    model = dense_model(device, conv, mode, dtype)
    model.train()
    opt = make_optimizer(model, DENSE_CFG[conv][1])
    train_step, _ = make_dense_steps()
    losses = []
    for i, batch in enumerate(batches[:steps]):
        losses.append(train_step(model, opt, batch))
        if per_step is not None:
            per_step(i)
    return [float(x) for x in losses], model


def train_dense(card, dev, conv="PPGN", mode="DD", dtype=None, plans=False):
    """A dense configuration trains on the card, computing in ``dtype``,
    in SD mode on the fused route where ``plans`` (the loader's K1
    triples for every pair of ``parse_spmamm_dims``) and on the densify
    route otherwise: :func:`dense_launch_count` launches of each of its
    kernel's roles a step and no other, finite losses, two runs bitwise
    identical, the CPU's losses within the tolerance (PPGN-DD over
    DENSE_CPU_STEPS steps of the same batches; the other paths on
    DENSE_CUT_STEPS batches of DENSE_CUT graphs, both sides); then
    graphs/s trained, a step's breakdown and the peak device memory.
    Returns the launches of the first training run and the peak."""
    import torch

    from pygho_tpu_torch.hodata import (MaDataloader, Mapretransform,
                                        spdsampler, synthetic_zinc)
    from pygho_tpu_torch.honn import parse_spmamm_dims
    from pygho_tpu_torch.kernels import KERNELS
    from pygho_tpu_torch.models import make_dense_steps, make_optimizer

    name = dense_name(conv, mode, dtype, plans)
    # the (dim1, dim2) pairs whose K1 triples the loader builds
    plan_dims = parse_spmamm_dims(dense_model("cpu", conv, mode)) \
        if plans else ((1, 2),)
    run = partial(dense_train_run, conv=conv, mode=mode, dtype=dtype)
    t0 = time.perf_counter()
    pre = Mapretransform(partial(spdsampler, hop=DENSE_HOP))
    datas = [pre(g) for g in synthetic_zinc("train", seed=SEED)]

    def loader(bs):
        return MaDataloader(datas, bs, shuffle=True, drop_last=True, seed=0,
                            denseadj=mode == "DD", build_plans=plans,
                            plan_dims=plan_dims)

    full = loader(128)
    batches = []
    while len(batches) < TRAIN_STEPS:      # 8 batches an epoch
        batches.extend(full)
    batches = batches[:TRAIN_STEPS]
    print(f"{name} training data: {len(datas)} graphs of synthetic_zinc("
          f"\"train\"), {TRAIN_STEPS} shuffled batches of 128 (loader seed "
          f"0, n padded to {batches[0]['X_data'].shape[1]}), preprocessed "
          f"and collated in {time.perf_counter() - t0:.3f} s")
    if plans:
        keys = [f"spmamm___{a}___{b}___acd" for a, b in plan_dims]
        if not all(k in b for b in batches for k in keys):
            raise AssertionError(f"a batch lacks the K1 triples of {keys}")
        print(f"K1's triples a batch, for each of {keys}: "
              f"{batches[0][keys[0]].shape[1]}")

    counts = []

    def read(_):
        counts.append({mod.NAME: mod.launches for mod in KERNELS})

    sync()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts to 0 just before, read after every step
    for mod in KERNELS:
        mod.launches = 0
    t0 = time.perf_counter()
    losses, model = run(dev, batches, TRAIN_STEPS, read)
    sync()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(counts[-1])
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    print(f"trained {TRAIN_STEPS} steps in {run_s:.3f} s; losses "
          f"{[f'{x:.6f}' for x in losses]}; kernel launches {launches}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB")
    mine = {mod.NAME for mod in dense_roles(conv, mode, dtype, plans)}
    want = {mod.NAME: dense_launch_count(conv) if mod.NAME in mine else 0
            for mod in KERNELS}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")

    again, model2 = run(dev, batches, TRAIN_STEPS)
    state, state2 = model.state_dict(), model2.state_dict()
    same = again == losses and all(torch.equal(state[k], state2[k])
                                   for k in state)
    print(f"second run from the same seed: losses and all {len(state)} "
          f"parameters and buffers bitwise identical: {same}")
    if not same:
        raise AssertionError(f"two runs differ: {losses} vs {again}")
    del model, model2, state, state2

    tol = DENSE_BF16_TRAIN_RTOL if dtype is not None else DENSE_TRAIN_RTOL
    t0 = time.perf_counter()
    if conv == "PPGN":
        card_losses, what = losses[:DENSE_CPU_STEPS], "the first"
        cpu_losses, _ = run("cpu", batches, DENSE_CPU_STEPS)
    else:
        cut = list(loader(DENSE_CUT))[:DENSE_CUT_STEPS]
        card_losses, _ = run(dev, cut, DENSE_CUT_STEPS)
        what = f"batches of {DENSE_CUT} graphs (the same on both sides),"
        cpu_losses, _ = run("cpu", cut, DENSE_CUT_STEPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    print(f"card vs CPU (plain versions), {what} {len(cpu_losses)} steps in "
          f"{time.perf_counter() - t0:.3f} s on the CPU: max relative loss "
          f"difference {rel:.3e} (tolerance {tol:g}); card losses "
          f"{[f'{x:.6f}' for x in card_losses]}, CPU losses "
          f"{[f'{x:.6f}' for x in cpu_losses]}")
    if not rel <= tol:
        raise AssertionError(f"card and CPU losses differ by {rel}")

    # graphs/s trained: one epoch of 8 steps after a warm-up epoch,
    # collation included, one sync at the end
    model = dense_model(dev, conv, mode, dtype)
    model.train()
    opt = make_optimizer(model, DENSE_CFG[conv][1])
    train_step, _ = make_dense_steps()
    for batch in full:
        train_step(model, opt, batch)
    sync()
    t0 = time.perf_counter()
    n = 0
    for batch in full:
        train_step(model, opt, batch)
        n += 128
    sync()
    gps = n / (time.perf_counter() - t0)
    dev_ms = time_ms(lambda: train_step(model, opt, batches[0]),
                     lambda: None, reps=5, warmup=1, settle=False)
    print(f"{name} training on {card}: {gps:.1f} graphs/s trained (one "
          f"epoch of 8 steps, collation included); one step {dev_ms:.3f} ms "
          f"between CUDA events (median of 5, copy included); peak device "
          f"memory {peak / 2 ** 30:.3f} GiB ({peak} bytes)")
    dense_step_breakdown(model, opt, full, dev)
    return launches, peak


def dense_step_breakdown(model, opt, loader, dev, reps=4):
    """One dense training step's parts, each synchronised, medians over
    ``reps`` steps: host collation, the copy to the card, forward+backward
    and the optimizer step."""
    from pygho_tpu_torch.hodata import batch_to_dense_dict
    from pygho_tpu_torch.models import masked_l1_loss

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
        dd, s = timed(lambda: batch_to_dense_dict(batch, ("",), dev))
        parts["copy"].append(s)

        def fwd_bwd():
            loss = masked_l1_loss(model(dd), dd["y"], dd["graph_mask"])
            opt.zero_grad(set_to_none=True)
            loss.backward()

        _, s = timed(fwd_bwd)
        parts["fwd+bwd"].append(s)
        _, s = timed(opt.step)
        parts["optimizer"].append(s)
    med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    print(f"one 128-graph training step (median of {reps}): host "
          f"collation {med['collation']:.3f} ms, copy to the card "
          f"{med['copy']:.3f} ms, forward+backward {med['fwd+bwd']:.3f} ms, "
          f"optimizer {med['optimizer']:.3f} ms; sum "
          f"{sum(med.values()):.3f} ms")


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
                                        synthetic_subgraphcount,
                                        synthetic_zinc)

    graphs = synthetic_zinc("val", seed=SEED)
    rng = np.random.default_rng(0)
    flush_buf = torch.empty(64 * 2 ** 20, device=dev)   # 256 MB > L2

    t0 = phase("kernels")
    pre = Sppretransform(partial(KhopSampler, hop=3), [""], [KEY])
    datas = [pre(g) for g in graphs]
    report = check_k1(datas, dev, rng, flush_buf.zero_)
    # K1's f32 roles at the subgraph convs' new shapes: SSWL's cross key
    # and PPGN-SS's 2-FWL key, on the same 128 graphs
    for key in (CROSS_KEY, FWL_KEY):
        t1 = time.perf_counter()
        key_pre = Sppretransform(partial(KhopSampler, hop=3), [""], [key])
        key_datas = [key_pre(g) for g in graphs]
        print(f"{key}: {len(graphs)} graphs preprocessed in "
              f"{time.perf_counter() - t1:.3f} s on the host")
        check_k1(key_datas, dev, rng, flush_buf.zero_, key=key,
                 edge_cases=False)
    # K1's f32 and f32fast roles at I2GNN's 3-tuple key, on a 128-graph
    # ZINC batch and a 64-graph batch of the count task
    i2_pre = Sppretransform(sparse_sampler("I2GNN"), [""], [I2_KEY])
    for what, source, bs in (("ZINC", graphs, 128),
                             ("count", synthetic_subgraphcount()[:64], 64)):
        t1 = time.perf_counter()
        i2_datas = [i2_pre(g) for g in source]
        print(f"{I2_KEY} ({what}): {len(source)} graphs preprocessed in "
              f"{time.perf_counter() - t1:.3f} s on the host")
        for exact in (True, False):
            check_k1(i2_datas, dev, rng, flush_buf.zero_, exact=exact,
                     key=I2_KEY, edge_cases=False, batch_size=bs,
                     label=f"{I2_KEY} {what} shape")
    dense_pre = Mapretransform(partial(spdsampler, hop=DENSE_HOP))
    dense_datas = [dense_pre(g) for g in graphs]
    report += check_k5(dense_datas, dev, rng, flush_buf.zero_)
    report += check_k5(dense_datas, dev, rng, flush_buf.zero_,
                       torch.bfloat16)
    report += check_k4(datas, dev, rng, flush_buf.zero_)
    # the fast and bf16 variants of K1 and K4
    for name, exact in FAST_VARIANTS:
        dtype = torch.bfloat16 if name == "bf16" else None
        report += check_k1(datas, dev, rng, flush_buf.zero_, dtype, exact)
        report += check_k4(datas, dev, rng, flush_buf.zero_, dtype, exact)
    t1 = time.perf_counter()
    giant = giant_instance()
    print(f"giant graph built in {time.perf_counter() - t1:.3f} s on the "
          f"host (RCM, hop-1 tuples and triples, inputs)")
    report += check_k3(giant, dev, rng, flush_buf.zero_)
    report += check_k3(giant, dev, rng, flush_buf.zero_, exact=False)
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
    dense_train_launches, _ = train_dense(card, dev)
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

    t0 = phase("NGNN fast serving")
    with math_mode(False):
        raw_gps, pre_gps, fast_launches = serve(graphs, rng, dev)
    print(f"NGNN-SS 6x128 (f32fast) serving on {card}: {raw_gps:.1f} "
          f"graphs/s from raw graphs (host precompute included), "
          f"{pre_gps:.1f} graphs/s from preprocessed graphs")
    done("NGNN fast serving", t0)

    t0 = phase("NGNN fast training")
    with math_mode(False):
        fast_train_launches = training(card, dev)
    done("NGNN fast training", t0)

    t0 = phase("NGNN bf16 training")
    with math_mode(False):
        bf16_train_launches = training(card, dev, dtype=torch.bfloat16)
    done("NGNN bf16 training", t0)

    t0 = phase("NGAT fast training")
    with math_mode(False):
        ngat_fast_launches = training(card, dev, "NGAT")
    done("NGAT fast training", t0)

    t0 = phase("NGNN-DD serving")
    raw_gps, pre_gps, ngnn_dd_launches = serve_dense(graphs, rng, dev,
                                                     "NGNN")
    print(f"NGNN-DD 6x128 serving on {card}: {raw_gps:.1f} graphs/s from "
          f"raw graphs (host precompute included), {pre_gps:.1f} graphs/s "
          f"from preprocessed graphs")
    done("NGNN-DD serving", t0)

    t0 = phase("NGNN-DD training")
    ngnn_dd_train_launches, f32_peak = train_dense(card, dev, "NGNN")
    done("NGNN-DD training", t0)

    t0 = phase("NGNN-DD bf16 training")
    ngnn_bf16_train_launches, bf16_peak = train_dense(
        card, dev, "NGNN", dtype=torch.bfloat16)
    print(f"NGNN-DD 6x128 peak device memory: bf16 compute "
          f"{bf16_peak / 2 ** 30:.3f} GiB against f32 "
          f"{f32_peak / 2 ** 30:.3f} GiB ({bf16_peak / f32_peak:.3f})")
    done("NGNN-DD bf16 training", t0)

    t0 = phase("NGNN-SD serving")
    raw_gps, pre_gps, ngnn_sd_launches = serve_dense(graphs, rng, dev,
                                                     "NGNN", "SD")
    print(f"NGNN-SD 6x128 (densify route) serving on {card}: {raw_gps:.1f} "
          f"graphs/s from raw graphs (host precompute included), "
          f"{pre_gps:.1f} graphs/s from preprocessed graphs")
    done("NGNN-SD serving", t0)

    t0 = phase("NGNN-SD training")
    sd_densify_launches, _ = train_dense(card, dev, "NGNN", "SD")
    sd_fused_launches, _ = train_dense(card, dev, "NGNN", "SD", plans=True)
    done("NGNN-SD training", t0)

    t0 = phase("giant fast training")
    giant_fast_launches = train_giant(card, dev, giant, "overlapped_fused",
                                      exact=False)
    done("giant fast training", t0)

    t0 = phase("ZINC entry point")
    zinc_launches = zinc_entry(card, dev)
    done("ZINC entry point", t0)

    t0 = phase("subgraph convs")
    subgraph_launches = []
    for conv in SUBGRAPH_CONVS:
        t1 = time.perf_counter()
        raw_gps, pre_gps, conv_launches = serve(graphs, rng, dev, conv)
        print(f"{conv}-SS 6x128 serving on {card}: {raw_gps:.1f} graphs/s "
              f"from raw graphs (host precompute included), {pre_gps:.1f} "
              f"graphs/s from preprocessed graphs")
        subgraph_launches += [conv_launches, training(card, dev, conv)]
        print(f"{conv}-SS 6x128 served and trained in "
              f"{time.perf_counter() - t1:.3f} s")
    done("subgraph convs", t0)

    t0 = phase("I2GNN")
    i2_launches = []
    for exact in (True, False):
        name = f"I2GNN-SS 6x128 ({mode_name(exact=exact)})"
        with math_mode(exact):
            raw_gps, pre_gps, conv_launches = serve(graphs, rng, dev,
                                                    "I2GNN")
            print(f"{name} serving on {card}: {raw_gps:.1f} graphs/s from "
                  f"raw graphs (host precompute included), {pre_gps:.1f} "
                  f"graphs/s from preprocessed graphs")
            i2_launches += [conv_launches, training(card, dev, "I2GNN")]
    i2_launches.append(count_entry(card, dev))
    done("I2GNN", t0)

    t0 = phase("dense subgraph convs")
    dense_subgraph_launches = []
    for conv in DENSE_SUBGRAPH_CONVS:
        t1 = time.perf_counter()
        for mode in ("DD", "SD"):
            raw_gps, pre_gps, conv_launches = serve_dense(graphs, rng, dev,
                                                          conv, mode)
            print(f"{dense_name(conv, mode)} serving on {card}: "
                  f"{raw_gps:.1f} graphs/s from raw graphs (host precompute "
                  f"included), {pre_gps:.1f} graphs/s from preprocessed "
                  f"graphs")
            dense_subgraph_launches += [conv_launches,
                                        train_dense(card, dev, conv, mode)[0]]
        if conv == "SSWL":
            # the fused route: K1 on the (1, 2) and (1, 1) triples
            dense_subgraph_launches.append(
                train_dense(card, dev, conv, "SD", plans=True)[0])
        print(f"{conv} served and trained in DD and SD in "
              f"{time.perf_counter() - t1:.3f} s")
    done("dense subgraph convs", t0)

    # launches: each main path's run (NGNN serving and training, dense
    # serving and training, NGAT serving and training, giant-graph
    # training, the fast and bf16 runs, the NGNN dense runs, the giant
    # graph's fast training, the ZINC entry point, the subgraph convs'
    # serving and training in the sparse and the dense modes, I2GNN's
    # serving and training in both modes and the count entry point), each
    # counted from 0 just before the path and read just after
    runs = (launches, train_launches, dense_launches, dense_train_launches,
            ngat_launches, ngat_train_launches, giant_launches,
            fast_launches, fast_train_launches, bf16_train_launches,
            ngat_fast_launches, ngnn_dd_launches, ngnn_dd_train_launches,
            ngnn_bf16_train_launches, ngnn_sd_launches, sd_densify_launches,
            sd_fused_launches, giant_fast_launches, zinc_launches,
            *subgraph_launches, *dense_subgraph_launches, *i2_launches)
    for line in report:
        line["launches"] = sum(run[line["name"]] for run in runs)
    unlaunched = [line["name"] for line in report if not line["launches"]
                  and line["name"] not in UNLAUNCHED]
    if unlaunched:
        raise AssertionError(f"kernels no main path launched: {unlaunched}")
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": report}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
