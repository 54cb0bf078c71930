"""Sparse pre-transform and dataloader (port of the sparse parts of
``pygho_tpu/hodata/loader.py``).

The loader collates in the calling thread: no collation threads and no
device prefetch.  In place of the TPU kernel plans (``add_spspmm_plans``)
it gives each precompute key what the CUDA kernel reads
(:func:`add_rowptr`): the real ``acd`` triples and their row pointer.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

from ..backend.indexing import PAD_INDEX
from ..honn.sp_operator import KEYSEP
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


def add_rowptr(batch: Dict[str, Any], keys: Sequence[str]) -> None:
    """For every precompute key of a collated batch (in place): strip the
    ``PAD_INDEX`` triples from ``batch["<key>___acd"]`` (now int32
    ``(3, k)``), check that ``a`` ascends and that every index is in
    range, and store the int32 row pointer of ``a`` over the padded target
    rows as ``batch["<key>___rowptr"]``.

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
        rowptr = np.zeros(out_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(a, minlength=out_rows), out=rowptr[1:])
        batch[f"{key}{KEYSEP}acd"] = np.ascontiguousarray(acd,
                                                          dtype=np.int32)
        batch[f"{key}{KEYSEP}rowptr"] = rowptr.astype(np.int32)


class SpDataloader:
    """Sparse batches, in dataset order, collated in the calling thread
    (reference Wrapper.py:101-132).  Yields numpy dicts with the kernels'
    row pointers added; ``batch_to_sparse_dict`` moves one onto a
    device.  The last batch is padded with empty graphs to
    ``batch_size``."""

    def __init__(self, dataset: List[Dict[str, Any]], batch_size: int,
                 keys: Sequence[str] = ("",)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.keys = tuple(keys)
        self.buckets: Dict[str, int] = Buckets()

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        bs = self.batch_size
        for s in range(0, len(self.dataset), bs):
            batch = collate_sparse(self.dataset[s:s + bs], self.keys,
                                   num_graphs=bs, buckets=self.buckets)
            add_rowptr(batch, self.keys)
            yield batch
