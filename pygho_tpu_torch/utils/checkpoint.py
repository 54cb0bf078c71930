"""Model and optimizer checkpoints (port of
``pygho_tpu/utils/checkpoint.py``).

The layout is the JAX package's: one ``step_<n>`` directory a checkpoint
under the given path, the latest restored unless a step is named.  What
goes inside differs: JAX writes an orbax pytree of the nnx state, the port
writes one ``state.pt`` with ``torch.save`` of the model's ``state_dict``
(parameters and BatchNorm running statistics), the optimizer's
``state_dict`` (AdamW's moments, step counts and learning rates, and the
port AdamW's schedule count) and the step.  Neither package reads the
other's checkpoints: carry JAX parameters across with
``weights.load_jax_params`` instead.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

_FILE = "state.pt"


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> str:
    """Save the model's and the optimizer's state to ``path/step_<step>``
    (replacing a checkpoint of the same step).  Returns the written
    directory."""
    d = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(d, exist_ok=True)
    state = {"step": int(step), "model": model.state_dict(),
             "optimizer": None if optimizer is None
             else optimizer.state_dict()}
    tmp = os.path.join(d, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(d, _FILE))
    return d


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       step: Optional[int] = None) -> int:
    """Restore a checkpoint of :func:`save_checkpoint` into ``model`` and
    ``optimizer`` in place, onto the device of the model's parameters.
    ``step=None`` restores the latest.  Returns the step."""
    base = os.path.abspath(path)
    if step is None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(base)
                       if d.startswith("step_") and os.path.exists(
                           os.path.join(base, d, _FILE)))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {base}")
        step = steps[-1]
    param = next(model.parameters(), None)
    where = param.device if param is not None else "cpu"
    state = torch.load(os.path.join(base, f"step_{step}", _FILE),
                       map_location=where, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"the checkpoint of step {step} holds no "
                             f"optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
