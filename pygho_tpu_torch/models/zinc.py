"""ZINC-style HOGNN models (port of ``InputEncoderSp``, ``SpModel``,
``make_sp_model``, ``InputEncoderMa``, ``MaModel`` and ``make_ma_model``
from ``pygho_tpu/models/zinc.py``; NGNN, NGAT, SSWL, DSSGNN, GNNAK, SUN
and PPGN in sparse mode, NGNN in the dense modes (DD, SD) and PPGN in
dense mode, each in f32 or with bf16 compute over f32 parameters).

``SpModel`` takes the datadict of ``hodata.batch_to_sparse_dict``,
``MaModel`` that of ``hodata.batch_to_dense_dict``; both return
``(num_graphs, num_tasks)`` predictions.  Module attributes carry the JAX
package's names, so ``weights.load_jax_params`` can map one onto the other.
"""

from __future__ import annotations

import dataclasses
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


def _sp_convdict(aggr: str, cpool: str, mlp: dict,
                 generator: torch.Generator):
    """Sparse conv factories (the JAX package's ``_sp_convdict``,
    ``models/zinc.py:107-131``, without I2GNN)."""
    g = dict(generator=generator)
    return {
        "NGNN": lambda d: Conv.NGNNConv(d, d, aggr, "SS", mlp, **g),
        "SSWL": lambda d: Conv.SSWLConv(d, d, aggr, "SS", mlp, **g),
        "DSSGNN": lambda d: Conv.DSSGNNConv(d, d, aggr, aggr, cpool, "SS",
                                            mlp, **g),
        "GNNAK": lambda d: Conv.GNNAKConv(d, d, aggr, cpool, "SS", mlp, mlp,
                                          **g),
        "SUN": lambda d: Conv.SUNConv(d, d, aggr, cpool, "SS", mlp, mlp,
                                      **g),
        "PPGN": lambda d: Conv.PPGNConv(d, d, aggr, "SS", mlp, **g),
        "NGAT": lambda d: Conv.NGATConv(d, d, aggr, "SS", mlp, **g),
    }


class SpModel(nn.Module):
    """Sparse HOGNN for graph regression (reference
    example/zinc.py:225-294).  Every sparse conv of the JAX package but
    I2GNN is ported; ``cpool`` is the cross-subgraph pooling of DSSGNN,
    GNNAK and SUN.

    ``dtype`` is the compute dtype (``torch.bfloat16`` for mixed
    precision): the MLPs and the tuple-init layers compute in it over f32
    parameters, and :meth:`encode_init` casts the node, edge and tuple
    features to it, as the JAX model's ``dtype`` does; the prediction comes
    out in f32.

    forward(datadict) -> (num_graphs, num_tasks)
    """

    def __init__(self, conv: str = "NGNN", num_tasks: int = 1,
                 num_layer: int = 6, hiddim: int = 128, aggr: str = "sum",
                 npool: str = "sum", lpool: str = "mean",
                 cpool: str = "mean", residual: bool = True,
                 outlayer: int = 2, mlp: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator):
        super().__init__()
        mlp = dict(mlp or {})
        mlp.setdefault("numlayer", 1)
        mlp.setdefault("tailact", True)
        if dtype is not None:
            mlp.setdefault("dtype", dtype)
        self.dtype = dtype
        convdict = _sp_convdict(aggr, cpool, mlp, generator)
        if conv not in convdict:
            raise NotImplementedError(
                f"conv {conv!r} is not ported yet; available: "
                f"{sorted(convdict)}")
        self.conv_name = conv
        self.hiddim = hiddim
        self.num_tasks = num_tasks
        self.residual = residual
        self.npool = npool

        self.lin_tupleinit0 = make_linear(hiddim, hiddim, generator=generator,
                                          dtype=dtype)
        self.lin_tupleinit1 = make_linear(hiddim, hiddim, generator=generator,
                                          dtype=dtype)
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
        """Encoder + cast to the compute dtype + tupleinit.  Returns
        (datadict, A, X)."""
        datadict = self.data_encoder(datadict)
        A, X, x = datadict["A"], datadict["X"], datadict["x"]
        if self.dtype is not None:
            x = x.to(self.dtype)
            if A.values is not None:
                A = dataclasses.replace(A, values=A.values.to(self.dtype))
            X = dataclasses.replace(X, values=X.values.to(self.dtype))
        return datadict, A, self.tupleinit(X, x)

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
                  device: DeviceLike = None,
                  dtype: Optional[torch.dtype] = None, **kw) -> SpModel:
    """Build an :class:`SpModel` with weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the CUDA card
    unless the caller passes ``device="cpu"``), computing in ``dtype``
    (``None``: f32; ``torch.bfloat16``: bf16 over f32 parameters)."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    return SpModel(conv, generator=generator, dtype=dtype, **kw).to(dev)


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
        A = datadict["A"]
        if isinstance(A, MaskedTensor):
            datadict["A"] = MaskedTensor(self.ea_encoder(A.data.long()),
                                         A.mask)
        else:   # the SD mode's sparse batched adjacency
            datadict["A"] = A.tuplewiseapply(
                lambda v: self.ea_encoder(v.reshape(v.shape[0]).long()))
        X: MaskedTensor = datadict["X"]
        datadict["X"] = MaskedTensor(self.tuplefeat_encoder(X.data.long()),
                                     X.mask)
        return datadict


def _ma_convdict(aggr: str, mlp: dict, mode: str,
                 generator: torch.Generator):
    """Dense conv factories (the ported part of the JAX package's
    ``_ma_convdict``): "DD" aggregates by sum only, "SD" by ``aggr``;
    PPGN is dense whatever the mode."""
    a = aggr if mode == "SD" else "sum"
    return {
        "NGNN": lambda d: Conv.NGNNConv(d, d, a, mode, mlp,
                                        generator=generator),
        "PPGN": lambda d: Conv.PPGNConv(d, d, a, "DD", mlp,
                                        generator=generator),
    }


class MaModel(nn.Module):
    """Masked-dense HOGNN for graph regression (reference
    example/zinc.py:155-222).  The NGNN conv in "DD" and "SD" mode and
    the PPGN conv are ported; ``remat`` raises.

    ``mode="DD"`` takes the dense adjacency of ``collate_dense``, ``"SD"``
    the sparse one of ``collate_dense(denseadj=False)``.  ``dtype`` is the
    compute dtype (``torch.bfloat16``: bf16 activations and products over
    f32 parameters, the JAX model's ``dtype``, ``--bf16`` of
    ``example/zinc_tpu.py``): the node, tuple and adjacency features are
    cast to it after the encoder, the MLPs and tuple-init layers compute in
    it, and the prediction comes out in f32.

    forward(datadict) -> (num_graphs, num_tasks)
    """

    def __init__(self, conv: str = "NGNN", num_tasks: int = 1,
                 num_layer: int = 6, hiddim: int = 128, aggr: str = "sum",
                 npool: str = "mean", lpool: str = "max",
                 cpool: str = "mean", residual: bool = True,
                 outlayer: int = 2, mlp: Optional[dict] = None,
                 mode: str = "DD", dtype: Optional[torch.dtype] = None,
                 remat: bool = False, *, generator: torch.Generator):
        super().__init__()
        if mode not in ("DD", "SD"):
            raise ValueError(f"mode must be 'DD' or 'SD', got {mode!r}")
        if remat:
            raise NotImplementedError("MaModel remat is not ported yet")
        mlp = dict(mlp or {})
        mlp.setdefault("numlayer", 1)
        mlp.setdefault("tailact", True)
        if dtype is not None:
            mlp.setdefault("dtype", dtype)
        convdict = _ma_convdict(aggr, mlp, mode, generator)
        if conv not in convdict:
            raise NotImplementedError(
                f"conv {conv!r} is not ported yet; available: "
                f"{sorted(convdict)}")
        self.dtype = dtype
        self.hiddim = hiddim
        self.residual = residual

        self.lin_tupleinit0 = make_linear(hiddim, hiddim, generator=generator,
                                          dtype=dtype)
        self.lin_tupleinit1 = make_linear(hiddim, hiddim, generator=generator,
                                          dtype=dtype)
        self.subggnns = nn.ModuleList(
            [convdict[conv](hiddim) for _ in range(num_layer)])
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
        A, X, x = datadict["A"], datadict["X"], datadict["x"]
        if self.dtype is not None:
            x = MaskedTensor(x.data.to(self.dtype), x.mask)
            X = MaskedTensor(X.data.to(self.dtype), X.mask)
            if isinstance(A, MaskedTensor):
                A = MaskedTensor(A.data.to(self.dtype), A.mask)
            elif A.values is not None:
                A = dataclasses.replace(A, values=A.values.to(self.dtype))
        X = self.tupleinit(X, x)
        for conv in self.subggnns:
            tX = conv(A, X, datadict)
            X = X.add(tX, True) if self.residual else tX
        xm = self.lpool_op(X)
        xm = xm.tuplewiseapply(lambda v: self.poolmlp(v, xm.mask))
        h_graph = self.npool_op(xm).fill_masked(0.0)
        return self.pred_lin(h_graph).float()


def make_ma_model(conv: str = "NGNN", seed: int = 0,
                  device: DeviceLike = None, **kw) -> MaModel:
    """Build a :class:`MaModel` with weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (the CUDA card
    unless the caller passes ``device="cpu"``); ``conv`` defaults to the
    JAX package's "NGNN"."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    return MaModel(conv, generator=generator, **kw).to(dev)
