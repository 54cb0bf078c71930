"""Pre-transforms and dataloaders, sparse and dense (port of
``pygho_tpu/hodata/loader.py``).

The loaders collate in the calling thread: no collation threads and no
device prefetch.  In place of the TPU kernel plans (``add_spspmm_plans``)
the sparse loader gives each precompute key what the CUDA kernels read
(:func:`add_rowptr`): the real ``acd`` triples and their row pointer, and
for training the same triples in the orders of the two backward roles.
The dense loader needs nothing of the kind for a dense adjacency (K5
reads the padded tensors); with a sparse one and ``build_plans`` it gives
the fused route of ``spmamm`` K1's triples in the same way
(:func:`add_spmamm_triples`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..backend.indexing import PAD_INDEX
from ..honn.sp_operator import KEYSEP
from ..kernels.fused_spmamm import spmamm_triples
from .ma_data import collate_dense, ma_datapreprocess
from .sp_data import collate_sparse, parsekey, sp_datapreprocess


class Buckets(dict):
    """Monotone bucket registry: a padded size can only grow, so batches
    of one loader keep reusing a small set of shapes.

    Every growth is recorded in ``events`` as ``(key, old, new)``, as the
    JAX package records it; ``drain_events()`` returns and clears them.
    A growth after the first epoch means a late outlier batch made a new
    padded shape: in JAX a recompile, here new allocations (the loaders
    collate in the calling thread, so no lock is needed)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.events: List[Tuple[str, int, int]] = []

    def __setitem__(self, key, value):
        old = self.get(key, 0)
        if value > old:
            self.events.append((key, old, value))
        super().__setitem__(key, max(value, old))

    def drain_events(self) -> List[Tuple[str, int, int]]:
        ev, self.events = self.events, []
        return ev


def Sppretransform(tuplesamplers, annotate: Sequence[str] = ("",),
                   keys: Sequence[str] = ("",)):
    """Build the sparse pre-transform (reference Wrapper.py:30-56)."""
    if callable(tuplesamplers):
        tuplesamplers = [tuplesamplers]
    return functools.partial(sp_datapreprocess,
                             tuplesamplers=tuplesamplers,
                             annotate=tuple(annotate), keys=tuple(keys))


def Mapretransform(tuplesamplers, annotate: Sequence[str] = ("",)):
    """Build the dense pre-transform (reference Wrapper.py:59-76)."""
    if callable(tuplesamplers):
        tuplesamplers = [tuplesamplers]
    return functools.partial(ma_datapreprocess,
                             tuplesamplers=tuplesamplers,
                             annotate=tuple(annotate))


def row_pointer(t: np.ndarray, rows: int) -> np.ndarray:
    """int32 CSR row pointer of the sorted row ids ``t`` over ``rows``."""
    rowptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(t, minlength=rows), out=rowptr[1:])
    return rowptr.astype(np.int32)


def backward_orders(acd: np.ndarray, c_rows: int, d_rows: int
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The triples of K1's two backward roles and their row pointers,
    from real ``acd`` triples sorted by ``a``:

    - ``"dx"``: ``(c, a, d)`` stably sorted by ``c``, row pointer over
      the ``c_rows`` rows of the ``c`` operand;
    - ``"da"``: ``(d, c, a)`` stably sorted by ``d``, row pointer over
      the ``d_rows`` rows of the ``d`` operand.

    The counterpart of the dX and dA plans of the JAX package
    (``build_spspmm_strip_plans``).  The stable sort keeps each output
    row's triples in ``a`` order, so the summation order is fixed."""
    a, c, d = np.asarray(acd, dtype=np.int64)
    out = {}
    for role, (t, u, v), rows in (("dx", (c, a, d), c_rows),
                                  ("da", (d, c, a), d_rows)):
        order = np.argsort(t, kind="stable")
        tuv = np.stack([t[order], u[order], v[order]]).astype(np.int32)
        out[role] = (tuv, row_pointer(tuv[0], rows))
    return out


def add_rowptr(batch: Dict[str, Any], keys: Sequence[str],
               backward: bool = False) -> None:
    """For every precompute key of a collated batch (in place): strip the
    ``PAD_INDEX`` triples from ``batch["<key>___acd"]`` (now int32
    ``(3, k)``), check that ``a`` ascends and that every index is in
    range, and store the int32 row pointer of ``a`` over the padded target
    rows as ``batch["<key>___rowptr"]``.

    With ``backward=True`` also store the two backward roles' triples
    and row pointers (:func:`backward_orders`) as ``<key>___acd_dx``,
    ``<key>___rowptr_dx``, ``<key>___acd_da`` and ``<key>___rowptr_da``:
    training needs them, serving does not.

    ``filterind`` sorts each graph's triples by ``a`` and block-diagonal
    collation keeps the order across graphs; the check makes a batch that
    breaks it fail here, on the host, and not in the kernel."""
    def rows_of(op):
        if op[0] == "X":
            return batch[f"tupleid{op[1:]}"].shape[1]
        return batch["edge_index"].shape[1]

    for key in keys:
        if not key:
            continue
        op0, op1, _, op2, _ = parsekey(key)
        acd = np.asarray(batch[f"{key}{KEYSEP}acd"])
        acd = acd[:, acd[0] < PAD_INDEX].astype(np.int64)
        a, c, d = acd
        out_rows = rows_of(op0)
        if a.size:
            if np.any(np.diff(a) < 0):
                raise ValueError(f"acd of {key!r} is not sorted by target")
            for name, idx, rows in (("a", a, out_rows),
                                    ("c", c, rows_of(op1)),
                                    ("d", d, rows_of(op2))):
                if idx.min() < 0 or idx.max() >= rows:
                    raise ValueError(f"acd of {key!r}: {name} out of range "
                                     f"[0, {rows})")
        batch[f"{key}{KEYSEP}acd"] = np.ascontiguousarray(acd,
                                                          dtype=np.int32)
        batch[f"{key}{KEYSEP}rowptr"] = row_pointer(a, out_rows)
        if backward:
            for role, (tuv, rowptr) in backward_orders(
                    acd, rows_of(op1), rows_of(op2)).items():
                batch[f"{key}{KEYSEP}acd_{role}"] = tuv
                batch[f"{key}{KEYSEP}rowptr_{role}"] = rowptr


def add_spmamm_triples(batch: Dict[str, Any],
                       plan_dims: Sequence[Tuple[int, ...]],
                       masked_ndim: int) -> None:
    """For every ``(dim1, dim2[, masked_ndim])`` of ``plan_dims``, give a
    collated SD batch (in place) the fused route's K1 arrays under the key
    ``spmamm___<dim1>___<dim2>``: the triples of
    :func:`kernels.fused_spmamm.spmamm_triples` as int32 ``___acd``, their
    row pointer ``___rowptr`` over ``rows = bsz * n_pad ** (masked_ndim -
    1)`` flat output rows, and the backward roles' orders
    (:func:`backward_orders`: dX over the adjacency's ``E_pad`` value
    rows, dA over the ``rows`` rows of B).  ``masked_ndim`` is B's masked
    rank with the batch, the tuple tensor's unless the third element of a
    pair gives another."""
    bsz, n_pad = batch["x"].shape[:2]
    counts = batch["node_mask"].sum(1).astype(np.int64)
    nnz_pad = batch["A_indices"].shape[1]
    for dims in plan_dims:
        dim1, dim2 = dims[0], dims[1]
        mnd = dims[2] if len(dims) > 2 else masked_ndim
        key = f"spmamm{KEYSEP}{dim1}{KEYSEP}{dim2}"
        tuv = spmamm_triples(batch["A_indices"], dim1, n_pad, counts,
                             mnd - 2)
        rows = bsz * n_pad ** (mnd - 1)
        batch[f"{key}{KEYSEP}acd"] = tuv.astype(np.int32)
        batch[f"{key}{KEYSEP}rowptr"] = row_pointer(tuv[0], rows)
        for role, (btuv, rowptr) in backward_orders(tuv, nnz_pad,
                                                    rows).items():
            batch[f"{key}{KEYSEP}acd_{role}"] = btuv
            batch[f"{key}{KEYSEP}rowptr_{role}"] = rowptr


class _BaseLoader:
    """Batches of ``dataset`` collated in the calling thread, each padded
    with empty graphs to ``batch_size`` (reference Wrapper.py:101-176).

    ``shuffle``, ``drop_last`` and ``seed`` have the JAX loader's
    semantics: one ``numpy.random.default_rng(seed)`` per loader shuffles
    the dataset order anew each epoch, and ``drop_last`` drops the last
    partial batch.  Shape buckets are kept across batches in
    ``buckets``."""

    def __init__(self, dataset: List[Dict[str, Any]], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.buckets: Dict[str, int] = Buckets()

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _collate(self, datas: List[Dict[str, Any]]) -> Dict[str, Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        stop = (len(idx) // bs) * bs if self.drop_last else len(idx)
        for s in range(0, stop, bs):
            yield self._collate([self.dataset[i] for i in idx[s:s + bs]])


class SpDataloader(_BaseLoader):
    """Sparse batches (reference Wrapper.py:101-132).  Yields numpy dicts
    with the kernels' row pointers added; ``batch_to_sparse_dict`` moves
    one onto a device.  ``backward=True`` adds the backward roles' triples
    (:func:`add_rowptr`), which a training step needs."""

    def __init__(self, dataset: List[Dict[str, Any]], batch_size: int,
                 keys: Sequence[str] = ("",), shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 backward: bool = False):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)
        self.keys = tuple(keys)
        self.backward = backward

    def _collate(self, datas):
        batch = collate_sparse(datas, self.keys, num_graphs=self.batch_size,
                               buckets=self.buckets)
        add_rowptr(batch, self.keys, self.backward)
        return batch


class MaDataloader(_BaseLoader):
    """Dense batches (reference Wrapper.py:135-176).  Yields the numpy
    dicts of ``collate_dense``; ``batch_to_dense_dict`` moves one onto a
    device.

    ``denseadj=False`` (SD mode) collates a sparse batched adjacency.
    With it, ``build_plans=True`` adds the fused route's K1 triples, row
    pointer and backward orders (:func:`add_spmamm_triples`) for the
    ``spmamm`` contractions in ``plan_dims`` (collect them with
    ``honn.parse_spmamm_dims(model)``), so that those contractions run on
    K1; without plans they take the densify route (K5).  The JAX loader
    ships its plans only where its TPU kernel's chunks come out at least
    half full (its chunk-fill guard); that guard measures the TPU's chunk
    geometry, which the port has none of (K1 walks a row pointer), so the
    port ships the triples whenever ``build_plans`` asks for them.  With a
    dense adjacency ``build_plans`` does nothing, as in the JAX package."""

    def __init__(self, dataset: List[Dict[str, Any]], batch_size: int,
                 annotate: Sequence[str] = ("",), denseadj: bool = True,
                 build_plans: bool = False,
                 plan_dims: Sequence[Tuple[int, ...]] = ((1, 2),),
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)
        self.annotate = tuple(annotate)
        self.denseadj = denseadj
        self.build_plans = build_plans
        self.plan_dims = tuple(tuple(p) for p in plan_dims)

    def _collate(self, datas):
        batch = collate_dense(datas, self.annotate,
                              num_graphs=self.batch_size,
                              buckets=self.buckets, denseadj=self.denseadj)
        if self.build_plans and not self.denseadj:
            masked_ndim = len(datas[0][f"tupleshape{self.annotate[0]}"]) + 1
            add_spmamm_triples(batch, self.plan_dims, masked_ndim)
        return batch


def padding_stats(batch: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Padding-waste report for one collated sparse batch (port of
    ``pygho_tpu/hodata/loader.py:595``): ``{name: {"real": r, "padded":
    p, "waste": 1 - r / p}}`` for the nodes, edges, tuples and every
    ``<key>___acd`` array present.  The port's loaders strip the padded
    triples (:func:`add_rowptr`), so an ``acd`` of their batches reports
    no waste: the kernels read no padded triple."""
    out: Dict[str, Dict[str, float]] = {}

    def rec(name, real, padded):
        real, padded = int(real), int(padded)
        out[name] = {"real": real, "padded": padded,
                     "waste": 1.0 - real / max(padded, 1)}

    if "num_nodes" in batch:
        rec("nodes", batch["num_nodes"], batch["x"].shape[0])
    if "num_edges" in batch:
        rec("edges", batch["num_edges"], batch["edge_index"].shape[1])
    for k in batch:
        if k.startswith("num_tuples"):
            ann = k[len("num_tuples"):]
            rec(f"tuples{ann}", batch[k], batch[f"tupleid{ann}"].shape[1])
        if k.endswith(f"{KEYSEP}acd"):
            a = np.asarray(batch[k][0])
            rec(k, int(np.sum(a < PAD_INDEX)), a.shape[0])
    return out
