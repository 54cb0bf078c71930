"""Preprocessing with a content-addressed disk cache (port of
``pygho_tpu/hodata/preprocess.py``; reference
pygho/hodata/ParallelPreprocess.py).

Maps the pre-transform over all graphs, in this process or in a process
pool, and caches the list of per-graph dicts as one pickle keyed by a
fingerprint of the transform, the reference's caching contract
(ParallelPreprocess.py:42-65).

The fingerprint starts with this package's name, so that a cache written
by the JAX package under the same directory (``dataset/SYNZINC_*`` holds
some) is never loaded here, nor one of this package there: the two
packages' per-graph dicts are alike but not the same objects.  It
describes the transform by value, ``functools.partial`` arguments and the
lists and tuples among them included, so one transform gives one
fingerprint in every process.
"""

from __future__ import annotations

import functools
import hashlib
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Dict, List, Sequence

from .graph import Graph

_CACHE_VERSION = 1
_PACKAGE = __name__.split(".")[0]


def _describe(f) -> str:
    if isinstance(f, functools.partial):
        kw = sorted((k, _describe(v)) for k, v in f.keywords.items())
        return (f"partial({_describe(f.func)}, "
                f"args={[_describe(a) for a in f.args]}, kw={kw})")
    if isinstance(f, (list, tuple)):
        return f"{type(f).__name__}({[_describe(x) for x in f]})"
    if callable(f):
        return f"{getattr(f, '__module__', '?')}." \
               f"{getattr(f, '__qualname__', repr(f))}"
    return repr(f)


def transform_fingerprint(pre_transform) -> str:
    """16 hex digits of a hash of this package's name, the cache version
    and the transform described by value."""
    return hashlib.sha256(
        f"{_PACKAGE}:v{_CACHE_VERSION}:{_describe(pre_transform)}".encode()
    ).hexdigest()[:16]


class ParallelPreprocessDataset:
    """Preprocess a list of Graphs with caching.

    Args:
      root: cache directory (created if needed).
      graphs: iterable of Graph.
      pre_transform: per-graph fn Graph -> dict (``Sppretransform`` /
        ``Mapretransform`` output, a picklable ``functools.partial``).
      num_worker: 0 = serial; > 0 = a pool of that many spawned
        processes.

    A cache under ``root`` with the transform's fingerprint is loaded in
    place of the preprocessing; else the datas are made and written there
    (through a temporary file, so a cut run leaves no half cache).
    ``cache_hit`` says which happened.
    """

    def __init__(self, root: str, graphs: Sequence[Graph],
                 pre_transform: Callable[[Graph], Dict[str, Any]],
                 num_worker: int = 0):
        os.makedirs(root, exist_ok=True)
        fp = transform_fingerprint(pre_transform)
        self.cache_path = os.path.join(root, f"processed_{fp}.pkl")
        self.cache_hit = os.path.exists(self.cache_path)
        if self.cache_hit:
            with open(self.cache_path, "rb") as f:
                self.datas: List[Dict[str, Any]] = pickle.load(f)
            return
        graphs = list(graphs)
        if num_worker and num_worker > 0:
            # spawned, not forked: the caller may hold threads (PyTorch's
            # pools) or a CUDA context, which a forked child inherits
            # broken
            with ProcessPoolExecutor(
                    max_workers=num_worker,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                self.datas = list(pool.map(pre_transform, graphs,
                                           chunksize=32))
        else:
            self.datas = [pre_transform(g) for g in graphs]
        tmp = f"{self.cache_path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.datas, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.cache_path)

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, i):
        return self.datas[i]
