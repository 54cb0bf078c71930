"""NN building blocks: a mask-aware BatchNorm and the MLP (port of
``pygho_tpu/honn/utils.py``).

Value arrays are padded, so the norm's statistics in training mode are
taken over the real rows only (``mask``); in eval mode it uses its running
statistics.  Weights are initialised from an explicit ``torch.Generator``
with the JAX package's initialisers (LeCun-normal kernels, zero biases).
An MLP may compute in another dtype than its f32 parameters (bf16 for
mixed precision), as the JAX package's ``MLP(dtype=...)`` does; its norms
keep their statistics in f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` with the compute dtype of ``flax.nnx.Linear``.

    Without ``compute_dtype`` the input is promoted to the parameters'
    dtype (f32) and the product is PyTorch's.  With it (bf16 over f32
    parameters), the input, the weight and the bias are cast to it, the
    product comes out in it (summed in f32 and rounded once), and the bias
    is added in it, as ``nnx.Linear(dtype=...)`` computes."""

    def __init__(self, indim: int, outdim: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(indim, outdim)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(
                x.to(torch.promote_types(x.dtype, self.weight.dtype)))
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def make_linear(indim: int, outdim: int, *, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Linear:
    """Linear layer with a LeCun-normal weight (a normal truncated at two
    standard deviations, rescaled to variance 1 / fan_in, as
    ``jax.nn.initializers.lecun_normal``) and a zero bias, f32, computing
    in ``dtype`` (:class:`Linear`)."""
    lin = Linear(indim, outdim, dtype)
    std = math.sqrt(1.0 / indim) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


# set while a checkpointed layer is recomputed in the backward pass
# (models.MaModel(remat=True)): its norms must not move their running
# statistics a second time
_FROZEN_STATS = False


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, every :class:`BatchNorm` in training mode normalises with
    its batch statistics as always but leaves its running statistics as
    they are: the recompute of a checkpointed layer, whose forward has
    updated them once already."""
    global _FROZEN_STATS
    was, _FROZEN_STATS = _FROZEN_STATS, True
    try:
        yield
    finally:
        _FROZEN_STATS = was


class BatchNorm(nn.Module):
    """Mask-aware batch normalisation over flattened leading dims
    (reference honn/utils.py:44-60; torch momentum semantics:
    running <- (1 - m) * running + m * batch).

    Parameters ``scale``/``bias`` and running statistics ``mean``/``var``
    carry the JAX package's names."""

    def __init__(self, dim: int, normparam: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = dim
        self.momentum = normparam
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float()  # statistics in f32
        d = x.shape[-1]
        if not self.training:
            mean, var = self.mean, self.var
        else:
            rows = x.reshape(-1, d)
            if mask is None:
                mean = rows.mean(0)
                var = rows.var(0, unbiased=False)
            else:
                m = mask.reshape(tuple(mask.shape)
                                 + (1,) * (x.dim() - 1 - mask.dim()))
                m = m.expand(x.shape[:-1]).reshape(-1, 1).to(x.dtype)
                cnt = m.sum().clamp_min(1.0)
                mean = (rows * m).sum(0) / cnt
                var = (((rows - mean) ** 2) * m).sum(0) / cnt
            if not _FROZEN_STATS:
                with torch.no_grad():
                    self.mean.copy_((1 - self.momentum) * self.mean
                                    + self.momentum * mean)
                    self.var.copy_((1 - self.momentum) * self.var
                                   + self.momentum * var)
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias
        return out.to(in_dtype)


act_dict: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "ELU": F.elu,
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class MLP(nn.Module):
    """Multi-layer perceptron (reference honn/utils.py:85-142).

    Layer stack (numlayer >= 1):
      [Linear(hid->hid), Norm, Dropout?, Act] * (numlayer - 1)
      Linear(hid->out)  [+ Norm, Dropout?, Act if tailact]

    numlayer == 0 is the identity (requires hiddim == outdim).  Every call
    takes an optional row-validity ``mask``, forwarded to the norms.
    ``dtype`` is the compute dtype of the linear layers (``None``: f32);
    the parameters stay f32.  Only the "bn" norm is ported, and no
    dropout (``dp`` must be 0).
    """

    def __init__(self, hiddim: int, outdim: int, numlayer: int,
                 tailact: bool, dp: float = 0.0, norm: str = "bn",
                 act: str = "relu", normparam: float = 0.1,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator):
        super().__init__()
        if numlayer < 0:
            raise ValueError("numlayer must be >= 0")
        if norm != "bn":
            raise NotImplementedError(f"norm {norm!r} is not ported yet")
        if dp != 0.0:
            raise NotImplementedError("dropout is not ported yet")
        self.numlayer = numlayer
        self.tailact = tailact
        self.act = act_dict[act]
        self.hid_lins = nn.ModuleList()
        self.hid_norms = nn.ModuleList()
        self.tail_lin = None
        if numlayer == 0:
            if hiddim != outdim:
                raise ValueError("an identity MLP needs hiddim == outdim")
            return
        for _ in range(numlayer - 1):
            self.hid_lins.append(make_linear(hiddim, hiddim,
                                             generator=generator,
                                             dtype=dtype))
            self.hid_norms.append(BatchNorm(hiddim, normparam))
        self.tail_lin = make_linear(hiddim, outdim, generator=generator,
                                    dtype=dtype)
        if tailact:
            self.tail_norm = BatchNorm(outdim, normparam)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for lin, bn in zip(self.hid_lins, self.hid_norms):
            x = self.act(bn(lin(x), mask))
        if self.tail_lin is None:
            return x
        x = self.tail_lin(x)
        if self.tailact:
            x = self.act(self.tail_norm(x, mask))
        return x


class HeteroLinear(nn.Module):
    """Type-conditional linear map, ``out = x @ weight[type] (+
    bias[type])`` (reference honn/utils.py:165-190, SUN's diagonal vs
    off-diagonal routing).  ``weight`` is ``(num_types, in, out)`` and
    ``bias`` ``(num_types, out)``, in the JAX layout and under the JAX
    names, so ``weights.load_jax_params`` copies them as they are.

    The JAX layer forms every type's product and selects one by a one-hot
    sum; this forms every type's product and selects one by
    ``torch.where``, which gives the selected product exactly where the
    one-hot sum adds zeros to it.  The weight is LeCun-normal with JAX's
    fan-in for a 3-D shape, ``in * num_types``; the input is promoted to
    the weight's dtype (f32), as JAX's einsum promotes a bf16 input."""

    def __init__(self, indim: int, outdim: int, num_types: int,
                 use_bias: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.num_types = num_types
        self.weight = nn.Parameter(torch.empty(num_types, indim, outdim))
        std = math.sqrt(1.0 / (indim * num_types)) / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        self.bias = nn.Parameter(torch.zeros(num_types, outdim)) \
            if use_bias else None

    def forward(self, x: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        sel = types.long().unsqueeze(-1)
        out = None
        for t in range(self.num_types):
            y = x @ self.weight[t]
            if self.bias is not None:
                y = y + self.bias[t]
            out = y if out is None else torch.where(sel == t, y, out)
        return out


def recalibrate_batchnorm(model: nn.Module, batches: Iterable,
                          forward: Callable[[nn.Module, object], object]
                          ) -> int:
    """Re-estimate every :class:`BatchNorm`'s running statistics as the
    mean over ``batches`` of each batch's statistics (port of
    ``pygho_tpu/honn/utils.py:214``; the post-training BN re-estimation
    behind ``--recalibrate_bn``).

    ``forward(model, batch)`` runs the model's forward on one batch; it
    runs under ``torch.no_grad()`` with every norm in training mode and
    momentum 1, so that a norm's running statistics become that batch's.
    The sums are f32, in batch order, as the JAX package takes them.  The
    norms' momentum and mode are restored afterwards.  Returns the number
    of batches."""
    bns = [mod for mod in model.modules() if isinstance(mod, BatchNorm)]
    saved = [(bn.momentum, bn.training) for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
        bn.train()
    sums = None
    n = 0
    try:
        with torch.no_grad():
            for batch in batches:
                forward(model, batch)
                stats = [(bn.mean.clone(), bn.var.clone()) for bn in bns]
                sums = stats if sums is None else [
                    (sm + m, sv + v) for (sm, sv), (m, v) in zip(sums, stats)]
                n += 1
            for bn, (sm, sv) in zip(bns, sums if n else ()):
                bn.mean.copy_(sm / n)
                bn.var.copy_(sv / n)
    finally:
        for bn, (m, training) in zip(bns, saved):
            bn.momentum = m
            bn.train(training)
    return n
