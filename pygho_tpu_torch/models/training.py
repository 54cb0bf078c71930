"""Training utilities: the learning-rate schedule, the optimizer, the loss
and the train/eval steps of sparse and dense models (port of
``pygho_tpu/models/training.py:28-132``).

The schedule is the reference's cosine annealing with warm restarts and a
polynomial decay of the restart amplitude
(reference example/lr_scheduler.py:20-28):

  lr(e) = 1/(1 + K*c + K2*c^2) * (min + (base - min) *
          (1 + cos(pi * t / T_i)) / 2)

with c = completed restarts, t = epoch within the cycle, and cycle length
T_i = T0 * T_mult^c, evaluated per step at the fractional epoch
``step / steps_per_epoch``.

The optimizer is AdamW with optax's defaults, stepped once per batch, over
the ``nn.Parameter``s only: BatchNorm running statistics are buffers and
are updated by the forward, not by the optimizer.  The steps run in the
parity mode (``serve.set_parity_numerics``): f32 without TF32, and
deterministic, so two runs from one seed give the same bits.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..hodata.ma_data import batch_to_dense_dict
from ..hodata.sp_data import batch_to_sparse_dict
from .serve import set_parity_numerics


def cosine_warm_restarts(base_lr: float, T0: int, steps_per_epoch: int,
                         eta_min: float = 0.0, K: float = 0.0,
                         K2: float = 0.0,
                         T_mult: int = 1) -> Callable[[int], float]:
    """Per-step schedule for integer ``T_mult`` >= 1: cycle c has length
    T0 * T_mult^c, and for T_mult > 1 the cycle index at epoch e is
    n = floor(log_Tm(e/T0 * (Tm - 1) + 1)) (the closed form the reference
    uses for epoch-indexed stepping, example/lr_scheduler.py:46-53)."""
    if T_mult < 1 or int(T_mult) != T_mult:
        raise ValueError(f"Expected integer T_mult >= 1, got {T_mult}")
    T_mult = int(T_mult)

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if T0 < 1:
            return base_lr
        if T_mult == 1:
            num_cos = math.floor(epoch / T0)
            t_cur = epoch - num_cos * T0
            T_i = T0
        else:
            num_cos = math.floor(math.log(epoch / T0 * (T_mult - 1) + 1.0)
                                 / math.log(T_mult))
            geo = (T_mult ** num_cos - 1.0) / (T_mult - 1)
            t_cur = epoch - T0 * geo
            T_i = T0 * T_mult ** num_cos
        amp = 1.0 / (1.0 + K * num_cos + K2 * num_cos ** 2)
        return amp * (eta_min + (base_lr - eta_min) *
                      (1.0 + math.cos(math.pi * t_cur / T_i)) / 2.0)

    return schedule


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` with optax's ``adamw`` defaults (betas 0.9 and
    0.999, eps 1e-8, weight decay as given) and, where ``lr`` is a
    schedule, the learning rate ``lr(count)`` set before each step, as
    optax evaluates its schedule at the update count (0 first)."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 weight_decay: float):
        self.schedule: Optional[Callable[[int], float]] = \
            lr if callable(lr) else None
        self.count = 0
        super().__init__(params, lr=self.schedule(0) if self.schedule
                         else lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)

    def step(self, closure=None):
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.param_groups:
                group["lr"] = lr
        self.count += 1
        return super().step(closure)


def make_optimizer(model: nn.Module,
                   lr: Union[float, Callable[[int], float]] = 1e-3,
                   weight_decay: float = 0.0) -> AdamW:
    """AdamW over the model's parameters.  ``weight_decay`` defaults to
    the JAX package's 0.0 (not PyTorch's 0.01)."""
    return AdamW(list(model.parameters()), lr, weight_decay)


def masked_l1_loss(pred: torch.Tensor, y: torch.Tensor,
                   graph_mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over real (non-padding) graphs
    (reference example/minimal.py:147: F.l1_loss)."""
    y = y.reshape(pred.shape)
    per = (pred - y).abs().mean(dim=-1)
    w = graph_mask.to(pred.dtype)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def _device_of(model: nn.Module) -> torch.device:
    param = next(model.parameters(), None)
    if param is None:
        raise ValueError("the model has no parameters to place the batch by")
    return param.device


def _make_steps(to_dict: Callable, annotate) -> Tuple[Callable, Callable]:
    set_parity_numerics()

    def train_step(model: nn.Module, opt: torch.optim.Optimizer,
                   batch: Dict[str, Any]) -> torch.Tensor:
        dd = to_dict(batch, annotate, _device_of(model))
        pred = model(dd)
        loss = masked_l1_loss(pred, dd["y"], dd["graph_mask"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Dict[str, Any]) -> torch.Tensor:
        dd = to_dict(batch, annotate, _device_of(model))
        pred = model(dd)
        y = dd["y"].reshape(pred.shape)
        w = dd["graph_mask"].to(pred.dtype)
        return torch.stack([((pred - y).abs().mean(-1) * w).sum(), w.sum()])

    return train_step, eval_step


def make_sparse_steps(annotate=("",)) -> Tuple[Callable, Callable]:
    """Train and eval steps for sparse models, in the parity mode.

    ``train_step(model, opt, batch) -> loss``: one AdamW step on a
    collated numpy batch, which must carry the backward roles' triples
    (``SpDataloader(..., backward=True)``); the loss comes back as a 0-d
    tensor on the model's device.
    ``eval_step(model, batch) -> (sum, count)``: the summed per-graph
    absolute error and the number of real graphs, as a 2-element tensor.
    The batch goes to the device of the model's parameters.  The caller
    sets ``model.train()`` or ``model.eval()``, as in the JAX package.
    """
    return _make_steps(batch_to_sparse_dict, annotate)


def make_dense_steps(annotate=("",)) -> Tuple[Callable, Callable]:
    """Train and eval steps for dense models (``MaModel``), in the parity
    mode, with :func:`make_sparse_steps`' contract; the batch comes from
    ``MaDataloader``."""
    return _make_steps(batch_to_dense_dict, annotate)
