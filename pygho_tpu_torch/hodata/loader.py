"""Pre-transforms and dataloaders, sparse and dense (port of
``pygho_tpu/hodata/loader.py``).

The loaders collate in the calling thread: no collation threads and no
device prefetch.  In place of the TPU kernel plans (``add_spspmm_plans``)
the sparse loader gives each precompute key what the CUDA kernels read
(:func:`add_rowptr`): the real ``acd`` triples and their row pointer, and
for training the same triples in the orders of the two backward roles.
The dense loader needs nothing of the kind: K5 reads the padded tensors.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ..backend.indexing import PAD_INDEX
from ..honn.sp_operator import KEYSEP
from .ma_data import collate_dense, ma_datapreprocess
from .sp_data import collate_sparse, parsekey, sp_datapreprocess


class Buckets(dict):
    """Monotone bucket registry: a padded size can only grow, so batches
    of one loader keep reusing a small set of shapes."""

    def __setitem__(self, key, value):
        super().__setitem__(key, max(value, self.get(key, 0)))


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
    device.  Only the dense adjacency is ported: ``denseadj=False`` (SD
    mode) and ``build_plans`` (the SD mode's K2 plans) raise."""

    def __init__(self, dataset: List[Dict[str, Any]], batch_size: int,
                 annotate: Sequence[str] = ("",), denseadj: bool = True,
                 build_plans: bool = False, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        if not denseadj or build_plans:
            raise NotImplementedError(
                "the SD mode (denseadj=False) and its kernel plans "
                "(build_plans) are not ported yet")
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)
        self.annotate = tuple(annotate)

    def _collate(self, datas):
        return collate_dense(datas, self.annotate,
                             num_graphs=self.batch_size,
                             buckets=self.buckets)
