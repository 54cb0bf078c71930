"""Carry a JAX model's weights into the port's model.

``load_jax_params(model, params)`` takes the JAX model's ``nnx.state``
flattened to numpy arrays by path, for example
``{("subggnns", 0, "lin", "tail_lin", "kernel"): array}`` (a dotted string
``"subggnns.0.lin.tail_lin.kernel"`` works as well).  The flattening is
done by the caller, so this module needs nothing of JAX.

The port's modules carry the JAX package's attribute names, so a path maps
onto a parameter or buffer of the same dotted name, with these changes:

- ``Linear.kernel`` ``(in, out)`` -> ``weight`` ``(out, in)``, transposed;
- ``Embed.embedding`` -> ``weight``;
- ``BatchNorm`` ``scale``/``bias``/``mean``/``var`` keep their names;
- ``HeteroLinear`` (SUN's ``lin1_0``) ``weight`` ``(num_types, in, out)``
  and ``bias`` keep their names and layout, and are copied as they are.

A plain parameter tree of nested dicts and lists, such as
``pygho_tpu.parallel.init_giant_params``'s, flattens to such paths with
:func:`flatten_params` (after ``jax.tree.map(np.asarray, tree)`` on the
caller's side).  The giant-graph stack (``parallel.giant.GiantNGNN``)
keeps that tree's names and layout: its ``w`` is ``(in, out)`` and is
named ``w``, not ``kernel``, so it is copied as it is, not transposed.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

Path = Union[str, Tuple]


def _dotted(path: Path) -> str:
    return path if isinstance(path, str) else ".".join(str(p) for p in path)


def flatten_params(tree, prefix: Tuple = ()) -> dict:
    """``{path: array}`` of a tree of nested dicts, lists and tuples of
    arrays, each path the tuple of keys and list indices down to it."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, sub in items:
        flat.update(flatten_params(sub, prefix + (key,)))
    return flat


def load_jax_params(model: nn.Module,
                    params: Mapping[Path, np.ndarray]) -> None:
    """Copy ``params`` into ``model`` in place.  Raises ``KeyError`` on a
    path with no counterpart or a parameter or buffer left unset, and
    ``ValueError`` on a shape that does not match."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    unset = set(targets)
    with torch.no_grad():
        for path, value in params.items():
            src = _dotted(path)
            prefix, _, leaf = src.rpartition(".")
            value = np.asarray(value)
            if leaf == "kernel":
                name, value = f"{prefix}.weight", value.T
            elif leaf == "embedding":
                name = f"{prefix}.weight"
            else:
                name = src
            if name not in targets:
                raise KeyError(f"JAX path {src!r} has no counterpart "
                               f"{name!r} in the model")
            dst = targets[name]
            if tuple(dst.shape) != value.shape:
                raise ValueError(f"{src!r}: JAX shape {value.shape} does not "
                                 f"fit {name!r} {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
            unset.discard(name)
    if unset:
        raise KeyError(f"no JAX value for {sorted(unset)}")
