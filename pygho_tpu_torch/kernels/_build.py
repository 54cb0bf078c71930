"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``pygho_tpu_torch/csrc/`` has a plain C interface and
includes no PyTorch header, so ``nvcc`` builds it into a shared library in
seconds.  The library goes into ``pygho_tpu_torch/_build/`` (ignored by
git) under a name keyed by a hash of the source and the flags, so a second
run loads it without building.  A build writes to a temporary name and
renames it into place, so two processes building at once do not see each
other's half-written file.

Nothing here runs when the package is imported: the first call of a
kernel on a CUDA tensor builds and loads its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills of each kernel go to
              # the build log beside the library
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home \
        else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the port's CUDA kernels "
                       "cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The key
    covers the source, the headers the sources share (``csrc/*.cuh``) and
    the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Build every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together.  Returns the seconds each build
    took (0.0 for one already built); raises if any build fails."""
    seconds = {name: 0.0 for name in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        final = library_path(name)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        log = open(final.with_suffix(".log"), "wb")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, final, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, final, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, final)
        else:
            failed.append((name, rc, final.with_suffix(".log")))
    if failed:
        msgs = [f"{n}: nvcc exit {rc}\n{p.read_text(errors='replace')}"
                for n, rc, p in failed]
        raise RuntimeError("CUDA build failed:\n" + "\n".join(msgs))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
