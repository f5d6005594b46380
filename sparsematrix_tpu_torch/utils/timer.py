"""Timing utilities: the host-clock accumulator and device timers.

Twin of ``sparsematrix_tpu/utils/timer.py``.  ``Timer`` mirrors the
reference's accumulator semantics (start/stop/pause/elapsed_ms);
``bench_fn`` times a call as its caller waits for it (host clock around
the call and a synchronise).

``bench_fn_slope`` and ``bench_chain_slope`` keep the JAX names, but not
the JAX method.  The JAX timers run a call 8 and 72 times inside one
device program and take the slope, perturbing the operands (``_looped``)
so XLA cannot hoist the work, and read one value back (``_fetch_one``):
a TPU reached through a relay cannot be timed call by call.  None of
that has a twin here.  On a CUDA tensor each call is timed alone
(``device_times``): CUDA events around it, the 50 MB L2 flushed before
it, and the call queued behind a ``torch.cuda._sleep`` spin twice as long
as the host took to issue one call, so the events see the device's time
and not the host's cost of issuing the call.  ``min_ms`` and ``mean_ms``
come from those times, the median goes into ``extras``, ``compile_ms`` is
the first call's wall time.  On CPU tensors the same timers use the host
clock.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Timer", "BenchResult", "bench_fn", "bench_fn_slope",
           "bench_chain_slope", "device_times", "timed_ms", "wall_ms",
           "spin_cycles_per_s", "ITERS", "WARMUP"]

ITERS = 30
WARMUP = 3
# bytes zeroed before each timed call: more than the H100's 50 MB L2
FLUSH_BYTES = 64 * 1024 * 1024


class Timer:
    def __init__(self):
        self._start = None
        self._accum = 0.0

    def start(self):
        self._accum = 0.0
        self._start = time.perf_counter()
        return self

    def pause(self):
        if self._start is not None:
            self._accum += time.perf_counter() - self._start
            self._start = None
        return self

    def resume(self):
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self.pause()
        return self._accum * 1e3

    @property
    def elapsed_ms(self) -> float:
        extra = time.perf_counter() - self._start if self._start is not None else 0.0
        return (self._accum + extra) * 1e3


@dataclass
class BenchResult:
    mean_ms: float
    min_ms: float
    compile_ms: float
    iters: int
    extras: Dict[str, Any] = field(default_factory=dict)


def device_times(fn: Callable[[], Any], flush: torch.Tensor,
                 spin_rate: float, iters: int = ITERS,
                 warmup: int = WARMUP) -> List[float]:
    """Device ms of each of ``iters`` calls of ``fn``, with the L2 flushed
    (``flush`` zeroed) before each.  Each timed call starts from a drained
    queue behind a spin kernel twice as long as the host took to issue one
    call in the warm-up, so the events see the device's time and not the
    host's cost of issuing the call (``wall_ms`` measures that).  A call
    of more launches than the stream's queue holds blocks the host until
    the card frees slots: the card is busy then, so the events still see
    no gap."""
    issue = []
    for _ in range(warmup):
        torch.cuda.synchronize()
        flush.zero_()
        t0 = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t0)
    spin = int((2.0 * max(issue, default=0.0) + 1e-4) * spin_rate)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def timed_ms(fn: Callable[[], Any], flush: torch.Tensor,
             spin_rate: float) -> float:
    """Median device time of one call of ``fn`` (``device_times``)."""
    return float(np.median(device_times(fn, flush, spin_rate)))


def wall_ms(fn: Callable[[], Any]) -> float:
    """Median latency of one call as its caller sees it: issued, then
    waited for (host clock, warm L2)."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def spin_cycles_per_s() -> float:
    """Clock cycles per second of ``torch.cuda._sleep`` on the current
    card."""
    torch.cuda._sleep(1_000_000)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / (start.elapsed_time(end) * 1e-3)


@functools.lru_cache(maxsize=None)
def _spin_rate(index: int) -> float:
    with torch.cuda.device(index):
        return spin_cycles_per_s()


def _cuda_device(obj, depth: int = 0) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``obj`` (a tensor, a
    container dataclass, or a tuple, list or dict of them), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if depth > 4:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        items = list(obj)
    else:
        return None
    for item in items:
        dev = _cuda_device(item, depth + 1)
        if dev is not None:
            return dev
    return None


def _sync(dev: Optional[torch.device]) -> None:
    if dev is not None:
        torch.cuda.synchronize(dev)


def _result(call: Callable[[], Any], dev: Optional[torch.device],
            iters: int, warmup: int) -> BenchResult:
    t0 = time.perf_counter()
    call()
    _sync(dev)
    compile_ms = (time.perf_counter() - t0) * 1e3
    if dev is None:
        for _ in range(warmup):
            call()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        clock = "host"
    else:
        with torch.cuda.device(dev):
            flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                device=dev)
            times = device_times(call, flush, _spin_rate(dev.index or 0),
                                 iters, warmup)
            del flush
        clock = "cuda events"
    return BenchResult(mean_ms=float(np.mean(times)),
                       min_ms=float(np.min(times)), compile_ms=compile_ms,
                       iters=iters,
                       extras={"median_ms": float(np.median(times)),
                               "clock": clock})


def bench_fn(fn: Callable, *args, iters: int = 20,
             warmup: int = 3) -> BenchResult:
    """Host-clock latency of ``fn(*args)``, waited for on the card."""
    dev = _cuda_device(args)
    t0 = time.perf_counter()
    fn(*args)
    _sync(dev)
    compile_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return BenchResult(mean_ms=sum(times) / len(times), min_ms=min(times),
                       compile_ms=compile_ms, iters=iters)


def bench_fn_slope(fn: Callable, *args, iters: int = ITERS,
                   warmup: int = WARMUP) -> BenchResult:
    """Time of one call of ``fn(*args)``: device time from CUDA events
    when an argument lies on the card, else the host clock."""
    return _result(lambda: fn(*args), _cuda_device(args), iters, warmup)


def bench_chain_slope(step: Callable, x0, *extra, iters: int = ITERS,
                      warmup: int = WARMUP) -> BenchResult:
    """Time of one link of the chain ``y ← step(y, *extra)`` (y0 = x0):
    each timed call takes the previous call's output.  ``step`` must be
    shape-preserving and keep magnitudes bounded (scale a product by
    about 1/n)."""
    state = [x0]

    def link():
        state[0] = step(state[0], *extra)
        return state[0]

    return _result(link, _cuda_device((x0, extra)), iters, warmup)
