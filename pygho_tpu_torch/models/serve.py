"""Batched prediction over raw graphs (port of ``SpPredictor`` from
``pygho_tpu/models/serve.py``).

``SpPredictor`` owns the host pipeline for inference: tuple-sampler
precompute, bucket-padded collation with shape buckets kept across calls,
an eval-mode forward under ``torch.inference_mode()``, and unpadding in
input order.  Host precompute runs in the calling process
(``num_workers=0``); the JAX package's process pool is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..hodata.loader import Buckets, SpDataloader, Sppretransform
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


class SpPredictor:
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
        if num_workers != 0:
            raise NotImplementedError(
                "host precompute workers are not ported; use num_workers=0")
        self.device = resolve_device(device)
        param = next(model.parameters(), None)
        if param is not None and param.device.type != self.device.type:
            raise ValueError(f"model is on {param.device}, predictor on "
                             f"{self.device}")
        self.model = model
        self.pre = Sppretransform(tuplesamplers, ("",), keys)
        self.keys = tuple(keys)
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
        loader = SpDataloader(datas, self.batch_size, self.keys)
        loader.buckets = self._buckets   # persist shape buckets
        preds = []
        with torch.inference_mode():
            for batch in loader:
                dd = batch_to_sparse_dict(batch, ("",), self.device)
                n_real = int(np.asarray(batch["graph_mask"]).sum())
                preds.append(self.model(dd)[:n_real].cpu().numpy())
        return np.concatenate(preds, axis=0)
