"""Batched prediction over raw graphs (port of ``SpPredictor`` and
``MaPredictor`` from ``pygho_tpu/models/serve.py``).

A predictor owns the host pipeline for inference: tuple-sampler
precompute, bucket-padded collation with shape buckets kept across calls,
an eval-mode forward under ``torch.inference_mode()`` in the parity mode,
and unpadding in input order.  Host precompute runs in the calling
process (``num_workers=0``); the JAX package's process pool is not
ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..hodata.loader import (Buckets, MaDataloader, Mapretransform,
                             SpDataloader, Sppretransform)
from ..hodata.ma_data import batch_to_dense_dict
from ..hodata.sp_data import batch_to_sparse_dict


# the cuBLAS workspace settings under which PyTorch lets deterministic
# algorithms use cuBLAS
DETERMINISTIC_CUBLAS = (":4096:8", ":16:8")


def set_parity_numerics() -> None:
    """The parity mode, which stands in for the JAX package's
    ``exact=True`` and its bitwise reproducibility: f32 matrix products
    and convolutions without TF32, and deterministic algorithms only.

    Under ``torch.use_deterministic_algorithms(True)`` the library sums
    that use atomics on CUDA (``index_add_`` in ``segment_reduce``, the
    backward of index gathers and of embedding lookups) switch to their
    sorted versions, and an operation that has none raises: determinism
    cannot switch off quietly on some path.  The K1 kernels need no atomics
    in any role.  PyTorch allows cuBLAS in this mode only with
    ``CUBLAS_WORKSPACE_CONFIG`` set to one of :data:`DETERMINISTIC_CUBLAS`
    before the first cuBLAS call; importing ``pygho_tpu_torch`` sets it
    where the environment does not, and this raises where it holds
    another value.  Outputs are written in full by every kernel of the
    port, so uninitialised memory is not filled first."""
    cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if cfg not in DETERMINISTIC_CUBLAS:
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG is {cfg!r}; deterministic cuBLAS "
            f"needs one of {DETERMINISTIC_CUBLAS}, set before the first "
            f"CUDA call")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


class _Predictor:
    """What both predictors share: the device check, the precompute, and
    the batched eval-mode forward with its predictions unpadded.
    Subclasses set ``self.pre`` and give :meth:`_loader` and
    :meth:`_to_dict`."""

    def __init__(self, model: nn.Module, batch_size: int, num_workers: int,
                 device: DeviceLike):
        if num_workers != 0:
            raise NotImplementedError(
                "host precompute workers are not ported; use num_workers=0")
        self.device = resolve_device(device)
        param = next(model.parameters(), None)
        if param is not None and param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, predictor on "
                             f"{self.device}")
        self.model = model
        self.batch_size = batch_size
        self._buckets = Buckets()

    def preprocess(self, graphs) -> List[Dict[str, Any]]:
        """Host-side tuple precompute (reusable across calls)."""
        return [self.pre(g) for g in graphs]

    def __call__(self, graphs) -> np.ndarray:
        graphs = list(graphs)
        datas = graphs if graphs and isinstance(graphs[0], dict) \
            else self.preprocess(graphs)
        set_parity_numerics()
        self.model.eval()
        loader = self._loader(datas)
        loader.buckets = self._buckets   # persist shape buckets
        preds = []
        with torch.inference_mode():
            for batch in loader:
                n_real = int(np.asarray(batch["graph_mask"]).sum())
                out = self.model(self._to_dict(batch))
                preds.append(out[:n_real].cpu().numpy())
        return np.concatenate(preds, axis=0)


class SpPredictor(_Predictor):
    """Order-preserving batched inference for sparse models.

    ``SpPredictor(model, partial(KhopSampler, hop=3), keys)`` then
    ``predictor(graphs) -> (len(graphs), num_tasks)`` as a numpy array.
    ``keys`` are the model's precompute keys (``parse_precomputekey``).
    The model must already be on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``).
    """

    def __init__(self, model: nn.Module, tuplesamplers,
                 keys: Sequence[str], batch_size: int = 128,
                 num_workers: int = 0, device: DeviceLike = None):
        super().__init__(model, batch_size, num_workers, device)
        self.pre = Sppretransform(tuplesamplers, ("",), keys)
        self.keys = tuple(keys)

    def _loader(self, datas):
        return SpDataloader(datas, self.batch_size, self.keys)

    def _to_dict(self, batch):
        return batch_to_sparse_dict(batch, ("",), self.device)


class MaPredictor(_Predictor):
    """Order-preserving batched inference for dense (masked) models:
    ``MaPredictor(model, partial(spdsampler, hop=4))`` then
    ``predictor(graphs) -> (len(graphs), num_tasks)``.  Every batch is
    padded with empty graphs to ``batch_size``.  Only the dense adjacency
    is ported (``denseadj=True``)."""

    def __init__(self, model: nn.Module, tuplesamplers,
                 annotate: Sequence[str] = ("",), batch_size: int = 128,
                 denseadj: bool = True, num_workers: int = 0,
                 device: DeviceLike = None):
        if not denseadj:
            raise NotImplementedError(
                "MaPredictor(denseadj=False), the SD mode, is not ported "
                "yet")
        super().__init__(model, batch_size, num_workers, device)
        self.pre = Mapretransform(tuplesamplers, annotate)
        self.annotate = tuple(annotate)

    def _loader(self, datas):
        return MaDataloader(datas, self.batch_size, self.annotate)

    def _to_dict(self, batch):
        return batch_to_dense_dict(batch, self.annotate, self.device)
