"""Training on one giant graph (port of ``pygho_tpu/parallel/giant.py``).

When one graph's tuple tensor is the whole workload, the JAX package
shards its tuple rows over a mesh axis and trains an NGNN-style stack with
the contraction split into local and boundary triples.  The port runs it
on one card (P = 1): one shard, no boundary, so every strategy of the JAX
package comes to the same triples, and the contraction of every layer runs
on K3 (``kernels/window_spspmm.py``), the short-row gather, in its forward
and dX roles.  The strategies that exchange boundary rows between cards (P > 1)
are not ported (``ROADMAP.md``, S7).

The strategies still differ in their math mode.  In JAX only
``overlapped_fused`` contracts on the Pallas kernel, which reads the fast
flag (``get_fused_math``, ``tuple_parallel.py:981``); the others contract
with XLA segment sums in f32 whatever the flag says
(``_overlapped_contract``, ``_pool_contract``).  So the plan keeps its
strategy, and only ``overlapped_fused`` runs K3's ``*_f32fast`` roles when
the flag is off (:func:`make_giant_graph_step`).

The stack, with the JAX package's math:

- per layer, ``h = relu(X @ w + b)``, the contraction
  ``out[a] = sum over (a, c, d) of h[c] * Av[d]``, and ``X = X + out``;
- the tuple rows summed into their root nodes (padded tuple rows, whose
  root is ``n_nodes``, are dropped, as JAX's ``segment_sum`` drops them);
- a ``(d, 1)`` readout, an MSE loss over the real nodes, and plain SGD,
  ``p - lr * grad``.

Everything data-dependent (the contraction's per-role triples, row
pointers and warp chunks, the root ids) is built on the host by
:func:`build_giant_graph_plan`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..backend.indexing import PAD_INDEX
from ..backend.segment import segment_reduce
from ..device import DeviceLike, resolve_device
from ..kernels.window_spspmm import (ChunkPlans, WindowSpspmmSum,
                                     build_chunk_plans)

# the JAX package's strategy names; at P = 1 each is one shard with no
# boundary, so all build the same triples
STRATEGIES = ("overlapped", "ring", "reduce_scatter", "overlapped_fused")
# the strategy whose contraction follows the fast-math flag
FUSED_STRATEGY = "overlapped_fused"


@dataclasses.dataclass
class GiantGraphPlan:
    """The plan of one giant graph's NGNN stack.

    ``contraction``: the (forward, dX, dA) chunk plans of the per-layer
    contraction (the same triples every layer: ``acd`` and the orders of
    ``backward_orders``, each with its row pointer and warp chunks); ``root_ids``: int64
    ``(P * B,)``, the root node of each tuple row, ``n_nodes`` for a
    padded row; ``n_nodes``: the node count (output rows of the pooling);
    ``P``: shards (1); ``B``: tuple rows a shard; ``strategy``: the JAX
    strategy it was built for (which decides the math mode)."""

    contraction: ChunkPlans
    root_ids: object
    n_nodes: int
    P: int
    B: int
    strategy: str = "overlapped"

    def to(self, device) -> "GiantGraphPlan":
        """The plan with its arrays as tensors on ``device``."""
        return dataclasses.replace(
            self, contraction=tuple(p.to(device) for p in self.contraction),
            root_ids=torch.as_tensor(np.asarray(self.root_ids)
                                     if not torch.is_tensor(self.root_ids)
                                     else self.root_ids,
                                     dtype=torch.int64).to(device))


def build_giant_graph_plan(acd: np.ndarray, tupleid: np.ndarray,
                           nnz_pad: int, n_nodes: int, P: int = 1,
                           strategy: str = "overlapped",
                           n_edge_rows: Optional[int] = None,
                           plan_dim: int = 128) -> GiantGraphPlan:
    """The plan of one giant graph, on the host (numpy arrays; see
    :meth:`GiantGraphPlan.to`).

    ``acd``: the contraction's triples ``(a, c, d)`` sorted by ``a``,
    padded with ``PAD_INDEX`` (``pad_acd``); ``tupleid``: the padded tuple
    indices ``(2, nnz_pad)``; ``n_edge_rows``: the rows of the edge values
    ``Av`` (default: the largest ``d`` + 1).  ``strategy`` takes the JAX
    package's names, which all give the one-card triples, and is kept for
    the math mode; ``P > 1`` raises.
    ``plan_dim`` is accepted for the JAX signature: the chunk plans do not
    depend on the width."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{STRATEGIES}")
    if P != 1:
        raise NotImplementedError(
            f"P = {P}: the multi-card giant-graph strategies (the boundary "
            f"exchange of ring, overlapped, reduce_scatter and "
            f"overlapped_fused) are not ported yet (ROADMAP.md, S7); the "
            f"port trains a giant graph on one card, P = 1")
    if plan_dim < 1:
        raise ValueError(f"plan_dim must be at least 1, got {plan_dim}")
    acd = np.asarray(acd)
    acd = acd[:, acd[0] < PAD_INDEX].astype(np.int64)
    if n_edge_rows is None:
        n_edge_rows = int(acd[2].max()) + 1 if acd.size else 1
    contraction = build_chunk_plans(acd, nnz_pad, n_edge_rows, nnz_pad)
    tid0 = np.asarray(tupleid)[0]
    if tid0.shape[0] != nnz_pad:
        raise ValueError(f"tupleid has {tid0.shape[0]} columns, nnz_pad "
                         f"is {nnz_pad}")
    root = np.where(tid0 < PAD_INDEX, tid0, n_nodes).astype(np.int64)
    return GiantGraphPlan(contraction=contraction, root_ids=root,
                          n_nodes=int(n_nodes), P=P, B=nnz_pad // P,
                          strategy=strategy)


class GiantLinear(nn.Module):
    """``x @ w + b`` with ``w`` ``(in, out)``, named as in the JAX
    package's parameter tree (``{"w": ..., "b": ...}``)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return x @ self.w + self.b


class GiantNGNN(nn.Module):
    """The giant graph's NGNN stack: ``layers`` of
    :class:`GiantLinear` ``(d, d)`` and the readout ``out`` ``(d, 1)``, the
    parameter names of ``init_giant_params``'s pytree
    (``layers.<i>.w``, ``layers.<i>.b``, ``out.w``, ``out.b``)."""

    def __init__(self, num_layer: int, d: int):
        super().__init__()
        self.layers = nn.ModuleList(GiantLinear(d, d)
                                    for _ in range(num_layer))
        self.out = GiantLinear(d, 1)

    def forward(self, Xv: torch.Tensor, Av: torch.Tensor,
                plan: GiantGraphPlan, exact: bool = True) -> torch.Tensor:
        """Predictions of the ``plan.n_nodes`` nodes, ``(n_nodes,)``, each
        layer's contraction in the math mode ``exact``."""
        X = Xv
        for lin in self.layers:
            h = torch.relu(lin(X))
            X = X + WindowSpspmmSum.apply(h, Av, plan.contraction, exact)
        node_h = segment_reduce(X, plan.root_ids, plan.n_nodes, "sum")
        return self.out(node_h)[:, 0]


def init_giant_params(num_layer: int, d: int, seed: int = 0,
                      device: DeviceLike = None) -> GiantNGNN:
    """The stack with the JAX package's shapes and scales: each ``w``
    ``N(0, 1) / sqrt(d)`` from a ``torch.Generator`` seeded with
    ``seed``, each ``b`` zero.  (The numbers differ from JAX's for one
    seed; carry JAX's across with ``weights.load_jax_params``.)"""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = GiantNGNN(num_layer, d)
    scale = 1.0 / math.sqrt(d)
    with torch.no_grad():
        for lin in list(model.layers) + [model.out]:
            lin.w.copy_(torch.randn(lin.w.shape, generator=gen) * scale)
    return model.to(dev)


def make_giant_graph_step(plan: GiantGraphPlan, num_layer: int,
                          lr: float = 1e-3, n_real: Optional[int] = None,
                          device: DeviceLike = None
                          ) -> Tuple[Callable, Callable]:
    """``(loss_fn, step)`` for the stack on ``plan`` (the counterpart of
    the JAX ``make_giant_graph_step`` at P = 1).

    ``loss_fn(model, Xv, Av, y)``: the MSE of the predictions against the
    node targets ``y`` ``(n_nodes,)``, averaged over the first ``n_real``
    nodes where ``n_real < n_nodes`` (padded node rows would add constant
    terms), else over all.  ``step(model, Xv, Av, y)``: one SGD step on
    the parameters in place, ``p = p - lr * grad``; returns the loss
    before the step.  ``Xv`` ``(P * B, d)`` and ``Av`` ``(n_edge_rows, d)``
    are inputs, not parameters: as in JAX, gradients are taken for the
    parameters only, so a step runs the forward and dX roles of K3
    ``num_layer`` times each and its dA role never.

    The math mode is read once, here, from :func:`get_fused_math`, as JAX
    reads the flag when it traces the jitted step: set the flag before
    building the step.  With the flag off and ``plan.strategy ==
    "overlapped_fused"`` the contraction runs K3's ``*_f32fast`` roles;
    every other strategy stays exact, as its JAX contraction does.

    Both run on ``device`` (the card unless ``device="cpu"``), where the
    plan is moved, in the parity mode (``set_parity_numerics``): f32
    without TF32 and deterministic algorithms, so two runs give the same
    bits."""
    from ..kernels.numerics import get_fused_math
    from ..models.serve import set_parity_numerics

    exact = get_fused_math() or plan.strategy != FUSED_STRATEGY
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    plan = plan.to(dev)
    set_parity_numerics()

    def check(model, Xv, Av, y):
        if len(model.layers) != num_layer:
            raise ValueError(f"the model has {len(model.layers)} layers, "
                             f"the step {num_layer}")
        for name, t in (("Xv", Xv), ("Av", Av), ("y", y),
                        ("the model", next(model.parameters()))):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, the step runs "
                                 f"on {dev}")
        if Xv.shape[0] != plan.P * plan.B or y.shape != (plan.n_nodes,):
            raise ValueError(f"Xv must have {plan.P * plan.B} rows and y "
                             f"shape ({plan.n_nodes},), got "
                             f"{tuple(Xv.shape)} and {tuple(y.shape)}")

    def loss_fn(model, Xv, Av, y):
        check(model, Xv, Av, y)
        se = (model(Xv, Av, plan, exact) - y) ** 2
        if n_real is not None and n_real < plan.n_nodes:
            return se[:n_real].sum() / n_real
        return se.mean()

    def step(model, Xv, Av, y):
        loss = loss_fn(model, Xv, Av, y)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            for p, g in zip(model.parameters(), grads):
                p.copy_(p - lr * g)
        return loss.detach()

    return loss_fn, step
