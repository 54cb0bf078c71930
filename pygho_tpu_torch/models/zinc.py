"""ZINC-style HOGNN models (port of ``InputEncoderSp``, ``SpModel``,
``make_sp_model``, ``InputEncoderMa``, ``MaModel`` and ``make_ma_model``
from ``pygho_tpu/models/zinc.py``; NGNN and NGAT in sparse mode and PPGN
in dense mode, f32).

``SpModel`` takes the datadict of ``hodata.batch_to_sparse_dict``,
``MaModel`` that of ``hodata.batch_to_dense_dict``; both return
``(num_graphs, num_tasks)`` predictions.  Module attributes carry the JAX
package's names, so ``weights.load_jax_params`` can map one onto the other.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..backend.matensor import MaskedTensor
from ..backend.segment import segment_reduce
from ..backend.sptensor import SparseTensor
from ..device import DeviceLike, resolve_device
from ..honn import conv as Conv
from ..honn import ma_operator as MaOperator
from ..honn import tensorop as TensorOp
from ..honn.utils import MLP, make_linear


def make_embedding(num: int, dim: int, *,
                   generator: torch.Generator) -> nn.Embedding:
    """Normal init with variance 1 / dim (the default of flax's
    ``nnx.Embed``)."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        nn.init.normal_(emb.weight, std=1.0 / math.sqrt(dim),
                        generator=generator)
    return emb


class InputEncoderSp(nn.Module):
    """Categorical encoders for node / edge / tuple features
    (reference example/minimal.py:22-34)."""

    def __init__(self, hiddim: int, *, generator: torch.Generator,
                 num_x: int = 32, num_ea: int = 16, num_tf: int = 16):
        super().__init__()
        self.x_encoder = make_embedding(num_x, hiddim, generator=generator)
        self.ea_encoder = make_embedding(num_ea, hiddim,
                                         generator=generator)
        self.tuplefeat_encoder = make_embedding(num_tf, hiddim,
                                                generator=generator)

    def forward(self, datadict: Dict) -> Dict:
        datadict = dict(datadict)
        x = datadict["x"]
        datadict["x"] = self.x_encoder(x.reshape(x.shape[0], -1)[:, 0])
        if datadict["A"].values is not None:
            datadict["A"] = datadict["A"].tuplewiseapply(
                lambda v: self.ea_encoder(v.reshape(v.shape[0])))
        datadict["X"] = datadict["X"].tuplewiseapply(
            lambda v: self.tuplefeat_encoder(v.reshape(v.shape[0])))
        return datadict


def _sp_convdict(aggr: str, mlp: dict, generator: torch.Generator):
    """Sparse conv factories (the ported part of the JAX package's
    ``_sp_convdict``)."""
    return {
        "NGNN": lambda d: Conv.NGNNConv(d, d, aggr, "SS", mlp,
                                        generator=generator),
        "NGAT": lambda d: Conv.NGATConv(d, d, aggr, "SS", mlp,
                                        generator=generator),
    }


class SpModel(nn.Module):
    """Sparse HOGNN for graph regression (reference
    example/zinc.py:225-294).  The NGNN and NGAT convs are ported.

    forward(datadict) -> (num_graphs, num_tasks)
    """

    def __init__(self, conv: str = "NGNN", num_tasks: int = 1,
                 num_layer: int = 6, hiddim: int = 128, aggr: str = "sum",
                 npool: str = "sum", lpool: str = "mean",
                 residual: bool = True, outlayer: int = 2,
                 mlp: Optional[dict] = None, *,
                 generator: torch.Generator):
        super().__init__()
        mlp = dict(mlp or {})
        mlp.setdefault("numlayer", 1)
        mlp.setdefault("tailact", True)
        convdict = _sp_convdict(aggr, mlp, generator)
        if conv not in convdict:
            raise NotImplementedError(
                f"conv {conv!r} is not ported yet; available: "
                f"{sorted(convdict)}")
        self.conv_name = conv
        self.hiddim = hiddim
        self.num_tasks = num_tasks
        self.residual = residual
        self.npool = npool

        self.lin_tupleinit0 = make_linear(hiddim, hiddim, generator=generator)
        self.lin_tupleinit1 = make_linear(hiddim, hiddim, generator=generator)
        self.subggnns = nn.ModuleList(
            [convdict[conv](hiddim) for _ in range(num_layer)])
        self.lpool = TensorOp.OpPoolingSubg2D("S", lpool)
        head = {k: v for k, v in mlp.items()
                if k not in ("numlayer", "tailact")}
        self.poolmlp = MLP(hiddim, hiddim, 1, tailact=True,
                           generator=generator, **head)
        self.data_encoder = InputEncoderSp(hiddim, generator=generator)
        self.pred_lin = MLP(hiddim, num_tasks, outlayer, tailact=False,
                            generator=generator, **head)

    def tupleinit(self, X: SparseTensor, x: torch.Tensor) -> SparseTensor:
        """X_ij <- W0 x_i * W1 x_j * X_ij (reference
        example/zinc.py:276-282)."""
        last = x.shape[0] - 1
        t0 = self.lin_tupleinit0(x)[torch.clamp(X.indices[0], max=last)]
        t1 = self.lin_tupleinit1(x)[torch.clamp(X.indices[1], max=last)]
        return X.tuplewiseapply(lambda v: t0 * t1 * v)

    def encode_init(self, datadict: Dict):
        """Encoder + tupleinit.  Returns (datadict, A, X)."""
        datadict = self.data_encoder(datadict)
        X = self.tupleinit(datadict["X"], datadict["x"])
        return datadict, datadict["A"], X

    def readout(self, X: SparseTensor, datadict: Dict) -> torch.Tensor:
        """Subgraph pool + node MLP + graph pool + prediction head."""
        xs = self.lpool(X)
        node_mask = torch.arange(xs.shape[0], device=xs.device) \
            < datadict["num_nodes"]
        xs = self.poolmlp(xs, node_mask)
        num_graphs = datadict["graph_mask"].shape[0]
        h_graph = segment_reduce(xs, datadict["batch"], num_graphs,
                                 self.npool)
        return self.pred_lin(h_graph).float()

    def forward(self, datadict: Dict) -> torch.Tensor:
        datadict, A, X = self.encode_init(datadict)
        for conv in self.subggnns:
            tX = conv(A, X, datadict)
            X = X.add(tX, True) if self.residual else tX
        return self.readout(X, datadict)


def make_sp_model(conv: str = "NGNN", seed: int = 0,
                  device: DeviceLike = None, **kw) -> SpModel:
    """Build an :class:`SpModel` with weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the CUDA card
    unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    return SpModel(conv, generator=generator, **kw).to(dev)


class InputEncoderMa(nn.Module):
    """Categorical encoders for the dense mode (reference
    example/zinc.py:58-72): node features, adjacency codes and tuple
    codes, each through its embedding.  Entries off the mask get the
    embedding of code 0 and stay masked."""

    def __init__(self, hiddim: int, *, generator: torch.Generator,
                 num_x: int = 32, num_ea: int = 16, num_tf: int = 16):
        super().__init__()
        self.x_encoder = make_embedding(num_x, hiddim, generator=generator)
        self.ea_encoder = make_embedding(num_ea, hiddim,
                                         generator=generator)
        self.tuplefeat_encoder = make_embedding(num_tf, hiddim,
                                                generator=generator)

    def forward(self, datadict: Dict) -> Dict:
        datadict = dict(datadict)
        x: MaskedTensor = datadict["x"]
        datadict["x"] = MaskedTensor(self.x_encoder(x.data[..., 0].long()),
                                     x.mask)
        A: MaskedTensor = datadict["A"]
        datadict["A"] = MaskedTensor(self.ea_encoder(A.data.long()), A.mask)
        X: MaskedTensor = datadict["X"]
        datadict["X"] = MaskedTensor(self.tuplefeat_encoder(X.data.long()),
                                     X.mask)
        return datadict


class MaModel(nn.Module):
    """Masked-dense HOGNN for graph regression (reference
    example/zinc.py:155-222).  Only the PPGN conv in "DD" mode, in f32,
    is ported; ``dtype``, ``remat`` and ``mode="SD"`` raise.

    forward(datadict) -> (num_graphs, num_tasks)
    """

    def __init__(self, conv: str = "PPGN", num_tasks: int = 1,
                 num_layer: int = 6, hiddim: int = 128, aggr: str = "sum",
                 npool: str = "mean", lpool: str = "max",
                 cpool: str = "mean", residual: bool = True,
                 outlayer: int = 2, mlp: Optional[dict] = None,
                 mode: str = "DD", dtype=None, remat: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if conv != "PPGN":
            raise NotImplementedError(
                f"conv {conv!r} is not ported yet; available: ['PPGN']")
        if mode != "DD":
            raise NotImplementedError(f"mode {mode!r} is not ported yet")
        if dtype is not None or remat:
            raise NotImplementedError(
                "MaModel dtype and remat are not ported yet")
        mlp = dict(mlp or {})
        mlp.setdefault("numlayer", 1)
        mlp.setdefault("tailact", True)
        self.hiddim = hiddim
        self.residual = residual

        self.lin_tupleinit0 = make_linear(hiddim, hiddim, generator=generator)
        self.lin_tupleinit1 = make_linear(hiddim, hiddim, generator=generator)
        # the dense mode aggregates by sum only (_ma_convdict)
        self.subggnns = nn.ModuleList(
            [Conv.PPGNConv(hiddim, hiddim, "sum", "DD", mlp,
                           generator=generator) for _ in range(num_layer)])
        self.npool_op = MaOperator.OpPooling(1, pool=npool)
        self.lpool_op = TensorOp.OpPoolingSubg2D("D", lpool)
        head = {k: v for k, v in mlp.items()
                if k not in ("numlayer", "tailact")}
        self.poolmlp = MLP(hiddim, hiddim, 1, tailact=True,
                           generator=generator, **head)
        self.data_encoder = InputEncoderMa(hiddim, generator=generator)
        self.pred_lin = MLP(hiddim, num_tasks, outlayer, tailact=False,
                            generator=generator, **head)

    def tupleinit(self, X: MaskedTensor, x: MaskedTensor) -> MaskedTensor:
        """X_ij <- W0 x_i * W1 x_j * X_ij, the dense form of
        :meth:`SpModel.tupleinit`."""
        t0 = self.lin_tupleinit0(x.fill_masked(0.0))
        t1 = self.lin_tupleinit1(x.fill_masked(0.0))
        return X.tuplewiseapply(
            lambda v: t0[:, :, None, :] * t1[:, None, :, :] * v)

    def forward(self, datadict: Dict) -> torch.Tensor:
        datadict = self.data_encoder(datadict)
        A = datadict["A"]
        X = self.tupleinit(datadict["X"], datadict["x"])
        for conv in self.subggnns:
            tX = conv(A, X, datadict)
            X = X.add(tX, True) if self.residual else tX
        xm = self.lpool_op(X)
        xm = xm.tuplewiseapply(lambda v: self.poolmlp(v, xm.mask))
        h_graph = self.npool_op(xm).fill_masked(0.0)
        return self.pred_lin(h_graph).float()


def make_ma_model(conv: str = "PPGN", seed: int = 0,
                  device: DeviceLike = None, **kw) -> MaModel:
    """Build a :class:`MaModel` with weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the CUDA card
    unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    return MaModel(conv, generator=generator, **kw).to(dev)
