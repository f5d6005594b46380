"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` exports one C function ``<name>`` and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/kernels/``
at the repository root, named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library.  The libraries have
a plain C interface and are loaded with ``ctypes``; nothing links against
PyTorch, which keeps a build to seconds.  Importing this module builds
nothing.  Without ``nvcc`` the build raises.

``launch_counts`` counts, per kernel, the launches that the wrappers made:
each wrapper adds one where its kernel launched, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("codebook_spmm", "spmm_blocked_ell")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()

_lock = threading.Lock()
_funcs: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "sparsematrix_tpu_torch need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compiles every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    library path, the build seconds (0 when it was already built) and
    ``nvcc``'s output (the ``-Xptxas -v`` register and shared-memory
    report).  Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, Dict[str, object]] = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path),
                     "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str, argtypes: Sequence[type]) -> Callable[..., int]:
    """The C function ``name`` of ``csrc/<name>.cu``, built at first use,
    with ``argtypes`` set and an ``int`` (cudaError_t) result."""
    with _lock:
        fn = _funcs.get(name)
        if fn is None:
            lib = ctypes.CDLL(build([name])[name]["path"])
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _funcs[name] = fn
        return fn
