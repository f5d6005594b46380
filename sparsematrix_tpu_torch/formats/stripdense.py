"""StripDense — locally-densified row strips for band-local matrices.

Twin of ``sparsematrix_tpu/formats/stripdense.py``.  A band-local matrix
restricted to a 128-row strip touches only a narrow, contiguous column
window, so each strip is stored dense at that window, and SpMV/SpMM become
one batched (n_strips, 128, width) × (n_strips, width, k) product.
Padding inside a strip is explicit zeros.

``from_csr`` raises when some strip's column span exceeds ``max_width``
(the matrix is not band-local).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import SparseFormat, sparse_container, static_field

__all__ = ["StripDense"]

_LANES = 128


@sparse_container
@dataclasses.dataclass(frozen=True)
class StripDense(SparseFormat):
    strips: torch.Tensor  # (n_strips, rows_per_strip, width)
    first_col: torch.Tensor  # (n_strips,) int32 — window origin per strip
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()
    rows_per_strip: int = static_field()
    width: int = static_field()

    @property
    def fill_rate(self) -> float:
        return self.nnz / max(self.strips.numel(), 1)

    @classmethod
    def from_csr(cls, A, rows_per_strip: int = _LANES,
                 max_width: int | None = None) -> "StripDense":
        """Densify each ``rows_per_strip``-row strip at its column window,
        on the CSR's device.

        ``max_width`` bounds the stored window (default: 8192 or the
        column count, whichever is smaller); a strip whose nonzeros span
        more raises — StripDense is for band-local structure only.
        """
        dev = A.device
        sp = A.to_scipy().tocsr()
        sp.sum_duplicates()
        rows, cols = sp.shape
        n_strips = max(-(-rows // rows_per_strip), 1)
        cap = min(cols, 8192) if max_width is None else int(max_width)
        r = np.repeat(np.arange(rows), np.diff(sp.indptr))
        s = r // rows_per_strip
        # per-strip column span
        lo = np.full(n_strips, cols, np.int64)
        hi = np.full(n_strips, -1, np.int64)
        np.minimum.at(lo, s, sp.indices)
        np.maximum.at(hi, s, sp.indices)
        span = np.where(hi >= 0, hi - lo + 1, 0)
        if span.max(initial=0) > cap:
            bad = int(span.argmax())
            raise ValueError(
                f"StripDense: strip {bad} spans {int(span[bad])} columns "
                f"(> max_width={cap}); the matrix is not band-local — "
                "use CSR or BlockedELL instead")
        width = int(min(max(-(-int(span.max(initial=1)) // _LANES), 1)
                        * _LANES, cols))
        first = np.clip(np.where(hi >= 0, lo, 0), 0,
                        max(cols - width, 0)).astype(np.int64)
        strips = np.zeros((n_strips, rows_per_strip, width), sp.dtype)
        strips[s, r % rows_per_strip, sp.indices - first[s]] = sp.data
        return cls(
            strips=torch.from_numpy(strips).to(dev),
            first_col=torch.from_numpy(first).to(dev, torch.int32),
            shape=(rows, cols),
            nnz=int(sp.nnz),
            rows_per_strip=rows_per_strip,
            width=width,
        )

    def window_index(self) -> torch.Tensor:
        """(n_strips, width) column index of every stored strip column."""
        return (self.first_col.long()[:, None]
                + torch.arange(self.width, device=self.first_col.device))

    def todense(self) -> torch.Tensor:
        rows, cols = self.shape
        n_strips = self.strips.shape[0]
        out = torch.zeros((n_strips * self.rows_per_strip, cols + self.width),
                          dtype=self.strips.dtype, device=self.strips.device)
        rid = torch.arange(n_strips * self.rows_per_strip,
                           device=self.strips.device).reshape(
                               n_strips, self.rows_per_strip, 1)
        cid = self.window_index()[:, None, :]
        full = self.strips.shape
        out[rid.expand(full), cid.expand(full)] = self.strips
        return out[:rows, :cols]
