"""What the probe modules share: the command line, the card's name, the
timer, the bound and the JSON rows."""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..utils.roofline import PEAK_BYTES, PEAK_FP32
from ..utils.timer import FLUSH_BYTES, spin_cycles_per_s, timed_ms

__all__ = ["Session", "bound", "parser", "rel_err"]


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu "
                        "(the plain versions, no times)")
    p.add_argument("--out", default=None,
                   help="also write the rows, as a JSON list, to this file")
    return p


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32):
    """(bound_ms, bound_by): the larger of the operations at ``peak`` and
    the bytes at HBM's rate (H100 SXM, ``utils/roofline.py``)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (the probe scripts' check)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _card(dev: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None on the
    CPU."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


class Session:
    """One probe run: its device, its rows and its timer.

    ``ms(fn)`` is the median device time of one call of ``fn``
    (``utils/timer.timed_ms``: CUDA events, the 50 MB L2 flushed before
    each call, the call queued behind a spin kernel), or None on the CPU,
    where no device time exists.  ``emit(row)`` adds the card's
    ``nvidia-smi`` name and power limit, prints the row as one JSON line
    and, given ``out``, rewrites that file with every row so far."""

    def __init__(self, device=None, out: Optional[str] = None,
                 quiet: bool = False):
        self.dev = resolve_device(device)
        self.out = out
        self.quiet = quiet
        self.rows: List[Dict] = []
        self.card = _card(self.dev)
        self._flush = None
        self._spin = None

    @property
    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def ms(self, fn: Callable[[], object]) -> Optional[float]:
        if not self.cuda:
            return None
        if self._flush is None:
            self._flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                      device=self.dev)
            self._spin = spin_cycles_per_s()
        return timed_ms(fn, self._flush, self._spin)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def emit(self, row: Dict) -> Dict:
        row = {**row, "device": self.dev.type, "card": self.card}
        self.rows.append(row)
        if not self.quiet:
            print(json.dumps(row), flush=True)
        if self.out:
            with open(self.out, "w") as f:
                json.dump(self.rows, f, indent=1)
        return row
