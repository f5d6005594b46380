"""Profiling hooks: a ``torch.profiler`` trace and named time probes.

Twin of ``sparsematrix_tpu/utils/profiling.py``, under the same names.
``time_probe`` accumulates named wall-clock spans on the host (cheap,
always available); ``device_trace`` wraps a region in a
``torch.profiler`` trace of the host and, where there is a card, of its
kernels, and writes it as a Chrome trace (``chrome://tracing`` or
Perfetto).  The profiler is yielded, and ``kernel_times`` reads each
kernel's launches and device time from it::

    with device_trace("trace_dir") as prof:
        y = spmv(A, x)
        torch.cuda.synchronize()
    print(kernel_times(prof))   # {kernel name: {"count", "device_ms"}}

``annotate(name)`` is ``torch.profiler.record_function``: the name
appears in the trace as a span around what it encloses.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["time_probe", "probe_totals", "reset_probes", "device_trace",
           "kernel_times", "annotate"]

_probes: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def time_probe(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _probes[name] += time.perf_counter() - t0
        _counts[name] += 1


def probe_totals() -> Dict[str, tuple]:
    """{name: (total_ms, count)}"""
    return {k: (v * 1e3, _counts[k]) for k, v in _probes.items()}


def reset_probes() -> None:
    _probes.clear()
    _counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed region with ``torch.profiler`` (the host, and the
    card's kernels where CUDA is available) and write it to
    ``<logdir>/trace.json`` (a Chrome trace; a later trace into the same
    directory replaces it).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def kernel_times(prof) -> Dict[str, Dict[str, float]]:
    """{kernel name: {"count", "device_ms"}} of the CUDA kernels in a
    ``device_trace`` profiler (an empty dict for a CPU-only trace)."""
    return {evt.key: {"count": evt.count,
                      "device_ms": evt.device_time_total / 1e3}
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA}


def annotate(name: str):
    """Named trace annotation (a span in ``device_trace``'s trace)."""
    return torch.profiler.record_function(name)
