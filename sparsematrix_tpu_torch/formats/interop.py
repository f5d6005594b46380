"""Interop with ``torch.sparse``.

Twin of ``sparsematrix_tpu/formats/interop.py``'s ``from_torch`` and
``to_torch``: matrices move between torch's sparse tensors and this
package's containers without densifying.  The JAX module's
``from_bcoo``/``to_bcoo`` (``jax.experimental.sparse.BCOO``) are not
ported: they need ``jax``, which this package never imports.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as s
import torch

from .csr import CSR

__all__ = ["from_torch", "to_torch"]


def from_torch(t: torch.Tensor, capacity: int | None = None,
               device=None) -> CSR:
    """A ``torch.sparse_csr`` or ``sparse_coo`` tensor → CSR, on
    ``device`` (default: the tensor's device)."""
    device = t.device if device is None else device
    t = t.cpu()
    if t.layout == torch.sparse_csr:
        m = s.csr_matrix((t.values().numpy(), t.col_indices().numpy(),
                          t.crow_indices().numpy()), shape=tuple(t.shape))
        return CSR.from_scipy(m, capacity=capacity, device=device)
    tc = t.coalesce()
    idx = tc.indices().numpy()
    m = s.coo_matrix((tc.values().numpy(), (idx[0], idx[1])),
                     shape=tuple(t.shape))
    return CSR.from_scipy(m.tocsr(), capacity=capacity, device=device)


def to_torch(sp) -> torch.Tensor:
    """Any container with ``to_scipy`` → a ``torch.sparse_csr`` tensor on
    the container's device."""
    m = sp.to_scipy().tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int64)),
        torch.from_numpy(m.indices.astype(np.int64)),
        torch.from_numpy(m.data),
        size=m.shape,
    ).to(sp.device)
