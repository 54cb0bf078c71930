"""Training on one giant graph with the PyTorch / CUDA port
(``pygho_tpu_torch``): the workload of ``example/giant_graph_tpu.py`` on
one card.

Run: python example/giant_graph_gpu.py [--cpu] [--communities 200
     --csize 100 --hiddim 128 --num_layer 3 --steps 10]
     [--strategy overlapped_fused --fast]

It builds a community-structured graph, relabels it in reverse
Cuthill-McKee order, builds the hop-1 tuples and their contraction's
per-role plans (triples, row pointers, warp chunks) on the host, and
trains an NGNN stack with plain SGD, each layer's contraction on K3.  It runs on the CUDA card
unless ``--cpu`` is given; with no card and no ``--cpu`` it raises.  The
graph and the inputs are drawn from one ``numpy.random.default_rng(0)`` in
the JAX script's order, so both scripts train on the same data (the
parameters come from each package's own generator).  ``--devices`` takes
only 1: the multi-card strategies are not ported.  ``--fast`` sets the
fast numerics mode (``set_fused_math(False)``), which, as in the JAX
script, reaches only the ``overlapped_fused`` strategy's contraction: K3's
``*_f32fast`` roles on the card.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def community_graph(rng, communities, csize):
    """``communities`` blocks of ``csize`` nodes, ``5 * csize`` random
    edges inside each and 3 to the next block, both directions (the
    generator of ``example/giant_graph_tpu.py``)."""
    edges = []
    for ci in range(communities):
        base = ci * csize
        u = rng.integers(0, csize, csize * 5) + base
        v = rng.integers(0, csize, csize * 5) + base
        edges.append(np.stack([u, v]))
        u2 = rng.integers(0, csize, 3) + base
        v2 = rng.integers(0, csize, 3) + ((ci + 1) % communities) * csize
        edges.append(np.stack([u2, v2]))
    ei = np.concatenate(edges, axis=1)
    return np.concatenate([ei, ei[::-1]], axis=1)


def giant_instance(communities, csize, hiddim):
    """The graph, its hop-1 tuples and contraction triples, and the
    inputs, as numpy: a dict with ``n``, ``edge_index`` (after RCM),
    ``tup``, ``acd``, ``nnz_pad``, ``tupleid`` (padded), ``acd_pad``,
    ``Xv`` ``(nnz_pad, hiddim)``, ``Av`` ``(edges, hiddim)`` and ``y``
    (each node's degree over the largest)."""
    from pygho_tpu_torch.backend import indexing
    from pygho_tpu_torch.hodata.graph import Graph, rcm_reorder

    rng = np.random.default_rng(0)
    n = communities * csize
    ei = community_graph(rng, communities, csize)
    g = Graph(x=np.zeros((n, 1), np.int64), edge_index=ei, edge_attr=None)
    g = rcm_reorder(g.coalesced())
    # hop-1 tuples: each node with itself and its neighbours
    ii = np.concatenate([np.arange(n), g.edge_index[0]])
    jj = np.concatenate([np.arange(n), g.edge_index[1]])
    tup, _ = indexing.coalesce(np.stack([ii, jj]))
    tar, bcd = indexing.spspmm_ind(tup, 1, g.edge_index, 0)
    acd = indexing.filterind(tup, tar, bcd)
    nnz_pad = indexing.bucket_size(tup.shape[1])
    Xv = indexing.pad_values(
        rng.normal(size=(tup.shape[1], hiddim)).astype(np.float32) * 0.1,
        nnz_pad)
    Av = rng.normal(size=(g.num_edges, hiddim)).astype(np.float32) * 0.1
    deg = np.bincount(g.edge_index[0], minlength=n)
    return dict(n=n, edge_index=g.edge_index, tup=tup, acd=acd,
                nnz_pad=nnz_pad, tupleid=indexing.pad_indices(tup, nnz_pad),
                acd_pad=indexing.pad_acd(acd,
                                         indexing.bucket_size(acd.shape[1])),
                Xv=Xv, Av=Av, y=(deg / deg.max()).astype(np.float32))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", type=int, default=1)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--communities", type=int, default=100)
    parser.add_argument("--csize", type=int, default=30)
    parser.add_argument("--hiddim", type=int, default=32)
    parser.add_argument("--num_layer", type=int, default=3)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--strategy",
                        choices=["overlapped", "ring", "reduce_scatter",
                                 "overlapped_fused"],
                        default="overlapped",
                        help="the JAX script's boundary exchange; on one "
                             "card every strategy is the same plan, and "
                             "only overlapped_fused follows --fast")
    parser.add_argument("--fast", action="store_true",
                        help="bf16 fast math in the fused kernel "
                             "(overlapped_fused only)")
    args = parser.parse_args()
    if args.devices != 1:
        parser.error("--devices: only 1 is ported (one card); the "
                     "multi-card strategies are ROADMAP.md S7")

    import torch

    from pygho_tpu_torch.kernels import set_fused_math
    from pygho_tpu_torch.parallel import (build_giant_graph_plan,
                                          init_giant_params,
                                          make_giant_graph_step)

    if args.fast:
        set_fused_math(False)   # read when the step is built

    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")

    # 1. the graph, its tuples and triples
    t0 = time.perf_counter()
    inst = giant_instance(args.communities, args.csize, args.hiddim)
    print(f"graph: {inst['n']} nodes, {inst['edge_index'].shape[1]} edges")
    print(f"tuples: {inst['tup'].shape[1]}, contraction rows: "
          f"{inst['acd'].shape[1]} ({time.perf_counter() - t0:.1f}s)")

    # 2. the plans of the contraction's three roles
    t0 = time.perf_counter()
    plan = build_giant_graph_plan(inst["acd_pad"], inst["tupleid"],
                                  inst["nnz_pad"], inst["n"], args.devices,
                                  strategy=args.strategy,
                                  n_edge_rows=inst["Av"].shape[0],
                                  plan_dim=args.hiddim)
    fwd, dx, da = plan.contraction
    fast = args.fast and args.strategy == "overlapped_fused"
    print(f"plan ({args.strategy}, one card, "
          f"{'fast' if fast else 'exact'} math): {plan.B} tuple rows; "
          f"{fwd.tuv.shape[1]} triples; warps: forward {fwd.n_warps}, dX "
          f"{dx.n_warps}, dA {da.n_warps} ({time.perf_counter() - t0:.1f}s)")

    # 3. train
    model = init_giant_params(args.num_layer, args.hiddim, device=device)
    Xv, Av, y = (torch.from_numpy(inst[k]).to(device)
                 for k in ("Xv", "Av", "y"))
    loss_fn, step = make_giant_graph_step(plan, args.num_layer, lr=args.lr,
                                          device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    loss = step(model, Xv, Av, y)
    print(f"step 0: loss {float(loss):.5f} (first step, kernel build "
          f"included, {time.perf_counter() - t0:.1f}s)", flush=True)
    sync()
    t1 = time.perf_counter()
    for i in range(1, args.steps):
        loss = step(model, Xv, Av, y)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.5f}", flush=True)
    sync()
    steady = (time.perf_counter() - t1) / max(args.steps - 1, 1)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "the CPU"
    print(f"{args.steps} steps in {time.perf_counter() - t0:.1f}s "
          f"({steady * 1e3:.1f} ms/step steady) on {where}")


if __name__ == "__main__":
    main()
