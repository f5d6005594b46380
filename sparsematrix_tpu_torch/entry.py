"""Entry point: the flagship op at a small shape.

Twin of ``entry()`` in the repository's ``__graft_entry__.py``: the
reference's headline workload (dense A × codebook-quantized sparse B,
``add_mat_mat(a, b_t, c, 1.0, 1.0)``) at 32×256×512, 25 % dense, with the
same seed and generators, so both packages see the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .formats import CodebookDense
from .ops import add_mat_mat
from .utils.testutils import gen_matrix_random, gen_sparse_index_matrix

__all__ = ["entry"]


def entry(device=None):
    """``(fn, (a, b_t, c))`` with ``fn(*args)`` the AddMatMat step; the
    tensors lie on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    m, n, k = 32, 256, 512
    a = torch.from_numpy(gen_matrix_random(rng, m, k)).to(dev)
    c = torch.from_numpy(gen_matrix_random(rng, m, n)).to(dev)
    idx_mtx, table = gen_sparse_index_matrix(rng, k, n, density=0.25,
                                             table_size=255)
    # CodebookDense → fused dequant + product kernel on the card
    b_t = CodebookDense.from_index_matrix(idx_mtx, table, trans=True,
                                          device=dev)

    def fn(a, b_t, c):
        return add_mat_mat(a, b_t, c, alpha=1.0, beta=1.0)

    return fn, (a, b_t, c)
