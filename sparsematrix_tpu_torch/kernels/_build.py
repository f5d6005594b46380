"""Builds the native sources at first use and loads them.

Each ``csrc/<name>.cu`` exports a C function ``<name>`` (or several, one
per kernel it holds) and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/kernels/``
at the repository root, named by a hash of the flags, the source and the
headers it includes, so an edit rebuilds what it touches and an unchanged
tree reuses the library.  The libraries have a plain C interface and are
loaded with ``ctypes``; nothing links against PyTorch, which keeps a build
to seconds.  Without ``nvcc`` the build raises.

The host-side C++ helpers (``native/<name>.cc``: the packers' slot
assigners, the rowlane packer, the colorers of the permutation planner
and of SpGEMM, the ILU(0)/IC(0) factorizations) are built the same way by ``g++ -O3 -shared -fPIC
-pthread`` into ``build/host/`` (``build_host`` starts them all at once);
``load_host`` returns None where no ``g++`` is found, and the caller then
takes its numpy path.  Importing this module builds nothing.

``launch_counts`` counts, per kernel (``KERNELS``), the launches that the
wrappers made: each wrapper adds one where its kernel launched, and
nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["SOURCES", "KERNELS", "HOST_SOURCES", "BUILD_DIR", "build",
           "build_host", "load", "load_host", "launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "kernels"
HOST_BUILD_DIR = _PKG.parent / "build" / "host"
SOURCES = ("codebook_spmm", "spmm_blocked_ell", "spmv_dualgather",
           "spmm_dualgather", "window_permute", "spmv_octet", "spmv_rowlane",
           "spmv_superblock", "trisolve_waves", "trisolve_fused",
           "spmm_octet", "spmv_pooled", "spmv_sell", "spmm_bsr")
# the launch counters: one per kernel (a source may hold several)
KERNELS = ("codebook_spmm", "spmm_blocked_ell", "spmv_dualgather",
           "spmv_dualgather_sb", "spmm_dualgather", "spmm_dualgather_sb",
           "window_permute", "spmv_octet", "spmv_rowlane", "spmv_superblock",
           "trisolve_fused", "trisolve_chain", "trisolve_binv",
           "trisolve_chain_mm", "spmm_octet", "spmv_pooled", "spmv_sell",
           "spmv_sell_rowpure", "spmm_bsr", "spmm_bsr_panel")
# the host sources (native/<name>.cc)
HOST_SOURCES = ("assign", "rowlane", "octet", "color", "factor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

launch_counts: collections.Counter = collections.Counter()

_lock = threading.Lock()
_funcs: Dict[str, Callable[..., int]] = {}
_host_funcs: Dict[str, Optional[Callable[..., int]]] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "sparsematrix_tpu_torch need the CUDA toolkit")


def _with_includes(src: Path) -> List[Path]:
    """``src`` and every local header it includes, directly or not."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())
                 if (path.parent / inc).exists()]
    return seen


def _lib_path(src: Path, flags: Sequence[str], out_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(_with_includes(src)):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return out_dir / f"{src.stem}-{h.hexdigest()[:16]}.so"


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
        path = _lib_path(CSRC / f"{name}.cu", NVCC_FLAGS, BUILD_DIR)
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


def load(name: str, argtypes: Sequence[type],
         symbol: Optional[str] = None) -> Callable[..., int]:
    """The C function ``symbol`` (default ``name``) of ``csrc/<name>.cu``,
    built at first use, with ``argtypes`` set and an ``int`` (cudaError_t)
    result."""
    symbol = symbol or name
    with _lock:
        fn = _funcs.get(symbol)
        if fn is None:
            lib = ctypes.CDLL(build([name])[name]["path"])
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _funcs[symbol] = fn
        return fn


def _host_compile(name: str, gxx: str):
    """Starts ``g++`` on ``native/<name>.cc`` unless its library is built;
    returns (library path, the process or None)."""
    src = NATIVE / f"{name}.cc"
    path = _lib_path(src, GXX_FLAGS, HOST_BUILD_DIR)
    if path.exists():
        return path, None
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return path, (proc, tmp)


def _host_finish(name: str, path: Path, started) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cc:\n{log}")
    os.replace(tmp, path)


def build_host(names: Sequence[str] = HOST_SOURCES) -> Dict[str, str]:
    """Compiles every host library of ``names`` that is not built yet, one
    ``g++`` per source, all started together; returns the library paths.
    Raises if no ``g++`` is found or a compile fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host libraries need it")
    with _lock:
        started = {name: _host_compile(name, gxx) for name in names}
        for name, (path, proc) in started.items():
            _host_finish(name, path, proc)
    return {name: str(path) for name, (path, _) in started.items()}


def load_host(name: str, symbol: str,
              argtypes: Sequence[type]) -> Optional[Callable[..., int]]:
    """The C function ``symbol`` of ``native/<name>.cc``, built by ``g++``
    at first use, with ``argtypes`` set and a ``long`` result; None where
    no ``g++`` is found.  Raises if the compile fails."""
    with _lock:
        if symbol in _host_funcs:
            return _host_funcs[symbol]
        fn = None
        gxx = shutil.which("g++")
        if gxx is not None:
            path, started = _host_compile(name, gxx)
            _host_finish(name, path, started)
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_long
        _host_funcs[symbol] = fn
        return fn
