"""Planned permutations: ``out[i] = x[g[i]]`` for a map known at plan time.

Twin of ``sparsematrix_tpu/ops/permute.py``.  The host plans the map once
(``plan_gather_permutation`` / ``plan_permutation_auto``) and the apply
moves the data.  The JAX package ships the map as sort keys because an
arbitrary gather is slow on its chip; the port keeps the plan's fields
(``keys`` is the inverse bijection, ``gather`` the masked map) so that
plans are field-equal, and applies a sort plan as the scatter by the
bijection that ``lax.sort_key_val(keys, vals)`` computes, in plain torch.
Where the geometry allows, ``plan_permutation_auto`` returns a Clos plan
(``ops/permute_clos.py``), whose apply runs the window-permute kernel.

Row-wise applies ((n_src, k) inputs) move whole rows with plain torch
indexing, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..formats.base import sparse_container, static_field

__all__ = ["PermutePlan", "plan_gather_permutation", "apply_permutation",
           "plan_permutation_auto"]

# the JAX package's threshold between its gather and its sort apply (both
# give the same result; the plan records which one it chose)
SORT_MIN_ELEMS = 1 << 14


@sparse_container
@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """``out[i] = x[g[i]]`` as a scatter by a bijection.

    ``keys`` is the inverse of ``g`` extended to a bijection on [0, cap);
    the apply writes x (zero-padded to cap) to ``out[keys]``.  Slots whose
    ``g`` was a sentinel (or beyond x) read the zero padding.
    """

    keys: torch.Tensor  # (cap,) int32: inverse permutation
    n_out: int = static_field()
    n_src: int = static_field()
    use_sort: bool = static_field()
    gather: Optional[torch.Tensor] = None  # (n_out,) when not use_sort

    @property
    def cap(self) -> int:
        return self.keys.shape[0]


def _extend_bijection(g, n_src, n_out):
    """out-slot → source-id bijection ``p`` on [0, cap), with sentinel
    slots taking the unused ids (zero padding first); also whether some
    sentinel slot landed on a live source id (then the apply masks it)."""
    g = np.asarray(g)[:n_out]
    cap = max(n_out, n_src)
    real = g < n_src
    used = g[real]
    if len(np.unique(used)) != len(used):
        raise ValueError("gather map must be injective on real slots")
    p = np.full(cap, -1, np.int64)
    pre = p[:n_out]
    pre[real] = used
    p[:n_out] = pre
    unused = np.setdiff1d(np.arange(cap), used, assume_unique=False)
    # the above-n_src unused ids (zero padding) go to sentinel slots first
    p[p < 0] = unused[::-1]
    mask_needed = bool((p[:n_out][~real] < n_src).any())
    return g, p, cap, real, mask_needed


def plan_gather_permutation(g, n_src: int, n_out: int | None = None,
                            force_sort: bool | None = None,
                            device=None) -> PermutePlan:
    """Host-plan ``out[i] = x[g[i]]`` for an INJECTIVE index map ``g``, on
    ``device``.

    ``g`` entries in [0, n_src) select source elements (each at most
    once); entries ≥ n_src are sentinels reading 0.  ``n_out`` defaults to
    len(g).
    """
    dev = resolve_device(device)
    g = np.asarray(g)
    n_out = len(g) if n_out is None else n_out
    g, p, cap, real, mask_needed = _extend_bijection(g, n_src, n_out)
    keys = np.empty(cap, np.int64)
    keys[p] = np.arange(cap)
    use_sort = cap >= SORT_MIN_ELEMS if force_sort is None else force_sort
    return PermutePlan(
        keys=torch.from_numpy(keys).to(dev, torch.int32),
        n_out=int(n_out),
        n_src=int(n_src),
        use_sort=bool(use_sort),
        gather=(None if use_sort and not mask_needed
                else torch.from_numpy(np.where(real, g, n_src)).to(
                    dev, torch.int32)),
    )


def plan_permutation_auto(g, n_src: int, n_out: int | None = None,
                          device=None):
    """A Clos plan where the geometry supports one (from 2^14 outputs up to
    8 Mi elements), else the sort/gather plan.  ``apply_permutation``
    dispatches on the plan's type."""
    g = np.asarray(g)
    n = len(g) if n_out is None else n_out
    if n >= SORT_MIN_ELEMS:
        from .permute_clos import plan_clos_permutation

        p = plan_clos_permutation(g, n_src=n_src, n_out=n_out, device=device)
        if p is not None:
            return p
    return plan_gather_permutation(g, n_src=n_src, n_out=n_out, device=device)


def apply_permutation(plan, x: torch.Tensor) -> torch.Tensor:
    """Run the planned permutation: ``x`` is (n_src,) or longer (the tail
    is ignored), the result (n_out,).  A 2-D ``x`` of shape (n_src, k) is
    permuted row-wise.  Differentiable in ``x``."""
    from .permute_clos import ClosPermutePlan, apply_clos_permutation

    if x.dim() == 2:
        return _apply_permutation_rows(plan, x)
    if isinstance(plan, ClosPermutePlan):
        return apply_clos_permutation(plan, x)
    if not plan.use_sort:
        xp = torch.cat([x[: plan.n_src], x.new_zeros(1)])
        return xp[plan.gather.long()]
    vals = torch.cat([x[: plan.n_src], x.new_zeros(plan.cap - plan.n_src)])
    # sort_key_val(keys, vals) puts vals[s] at position keys[s]
    out = x.new_zeros(plan.cap).scatter(0, plan.keys.long(), vals)
    out = out[: plan.n_out]
    if plan.gather is not None:
        # some sentinel slots were keyed onto live source ids: zero them
        out = torch.where(plan.gather[: plan.n_out] < plan.n_src, out,
                          out.new_zeros(()))
    return out


def _apply_permutation_rows(plan, x: torch.Tensor) -> torch.Tensor:
    """Row-wise apply for (n_src, k) inputs: each moved row is one
    contiguous run of k elements."""
    from .permute_clos import ClosPermutePlan

    k = x.shape[1]
    if isinstance(plan, ClosPermutePlan):
        # inv maps each live source to its output slot (n_out = dropped
        # sink); sentinel output slots are never written and stay zero
        out = x.new_zeros((plan.n_out + 1, k)).index_copy(
            0, plan.inv.long(), x[: plan.n_src])
        return out[: plan.n_out]
    if not plan.use_sort:
        xp = torch.cat([x[: plan.n_src], x.new_zeros((1, k))])
        return xp[plan.gather.long()]
    # keys[s] is the destination slot of source s; live-but-unused sources
    # land on slots ≥ n_out (cut away) unless the plan recorded a
    # sentinel-slot collision, which the gather mask zeroes
    out = x.new_zeros((plan.cap, k)).index_copy(
        0, plan.keys[: plan.n_src].long(), x[: plan.n_src])[: plan.n_out]
    if plan.gather is not None:
        out = torch.where(plan.gather[: plan.n_out, None] < plan.n_src, out,
                          out.new_zeros(()))
    return out
