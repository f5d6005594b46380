"""The side structures that the card walks build from which values are
nonzero (``sector_mask``, ``group_real``, ``rowlane_walk``,
``superblock_walk``, ``octet_walk``, ``slab_walk``, ``fused_walk``) follow
in-place writes into the pack's or plan's values: a write builds them
anew, a read does not.

They are cached on the pack (``formats.base.cached_on``) and keyed on the
values' in-place write counter (``values_version``).  The kernels that
read them run only on the card (``test_torch_cuda.py``
``test_value_write_reaches_kernel``); here the structures themselves are
checked against fresh builds on the CPU.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from sparsematrix_tpu_torch.formats import CSR
from sparsematrix_tpu_torch.formats.base import cached_on, values_version
from sparsematrix_tpu_torch.kernels import (pack_dualgather, pack_octet,
                                            pack_sell_rowlane,
                                            pack_superblock,
                                            spmm_dualgather_reference,
                                            spmv_octet_reference,
                                            spmv_sell_rowlane_reference,
                                            spmv_superblock_reference)

trl = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_rowlane")
tsb = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_superblock")
toc = importlib.import_module("sparsematrix_tpu_torch.kernels.spmv_octet")
tsm = importlib.import_module("sparsematrix_tpu_torch.kernels.spmm_dualgather")
tfu = importlib.import_module("sparsematrix_tpu_torch.kernels.trisolve_fused")


def _lower_lanes(dev="cpu", rows=512, cols=2048, density=0.02, seed=3):
    """Entries only in lanes 0-63 of each 128-row tile: every slab's
    lanes 64-127 are all-zero sectors."""
    rng = np.random.default_rng(seed)
    keep = ((rng.random((rows, cols)) < density)
            & (np.arange(rows) % 128 < 64)[:, None])
    d = np.zeros((rows, cols), np.float32)
    d[keep] = rng.uniform(-1000, 1000, int(keep.sum()))
    return CSR.fromdense(d, device=dev)


def _sparse_rows(dev="cpu", rows=2048, cols=2048, seed=4):
    """Two entries a row: the octet layout's low degree."""
    sp = sps.random(rows, cols, density=2 / cols, random_state=seed,
                    format="csr", dtype=np.float32)
    return CSR.from_scipy(sp, device=dev)


def _same(a, b):
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if not isinstance(a, (tuple, torch.Tensor)):
        return a == b
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def _zero_sector(P):
    """(group, row, lane) of a zero value in a slab that holds values."""
    n_groups = P.vals.shape[0]
    v = P.vals.reshape(n_groups, P.group, 8, 128)
    g, k = map(int, torch.nonzero((v != 0).any(-1).any(-1))[0])
    assert not bool((v[g, k, 0, 64:72] != 0).any())
    return g, k * 8, 64


def _padding_slab(P):
    """(group, row, lane) in a slab past its group's last nonzero one."""
    real = trl._group_real_build(P)
    g = int(torch.nonzero(real < P.group)[0])
    return g, (P.group - 1) * 8, 0


def _zero_octet_slab(A):
    v = A.vals.reshape(-1, 1024)
    s = int(torch.nonzero(~(v != 0).any(1))[0])
    g, k = divmod(s, A.group)
    return g, k * 8, 0


def _fused_plan(dev="cpu"):
    from sparsematrix_tpu_torch.utils.testutils import triangular

    return tfu.trisolve_fused_plan(
        CSR.from_scipy(triangular(600, 3, band=200, seed=7), device=dev),
        level_sort=False)


def _zero_gated_slot(P):
    """(group, row, lane) of a zero slot that its segment's gate reads,
    over a column below n."""
    g, gh, lane = torch.nonzero(P.vals == 0).T
    win = P.slab_win.long()[g * P.group + gh // 8]
    col = win * 1024 + (gh % 8) * 128 + (P.s_idx[g, gh, lane].long() & 127)
    ok = (P.aux[P.seg_id.long()[g], 0, lane] != 0) & (col < P.shape[0])
    i = int(torch.nonzero(ok)[0])
    return int(g[i]), int(gh[i]), int(lane[i])


def _kt1_spmm(P, x):
    return spmm_dualgather_reference(P, x[:, None])[:, 0]


# getter, its fresh build, the pack on a device, the cell a write fills,
# the kernel's plain version
CASES = {
    "sector_mask": (trl.sector_mask, trl._sector_mask_build,
                    lambda dev: pack_sell_rowlane(_lower_lanes(dev), group=8),
                    _zero_sector, spmv_sell_rowlane_reference),
    "group_real": (trl.group_real, trl._group_real_build,
                   lambda dev: pack_sell_rowlane(_lower_lanes(dev), group=8),
                   _padding_slab, spmv_sell_rowlane_reference),
    "rowlane_walk": (lambda P: trl.rowlane_walk(P, 2),
                     lambda P: trl._walk_build(P, 2),
                     lambda dev: pack_sell_rowlane(_lower_lanes(dev),
                                                   group=8),
                     _padding_slab, spmv_sell_rowlane_reference),
    "superblock_walk": (lambda P: tsb.superblock_walk(P, 2),
                        lambda P: tsb._walk_build(P, 2),
                        lambda dev: pack_superblock(_lower_lanes(dev),
                                                    group=16, k_tiles=2),
                        _padding_slab, spmv_superblock_reference),
    "octet_walk": (toc.octet_walk, toc._walk_build,
                   lambda dev: pack_octet(_sparse_rows(dev), group=8,
                                          k_octets=2),
                   _zero_octet_slab, spmv_octet_reference),
    "kt1_walk": (tsm.slab_walk,
                 lambda P: tsm._slab_walk_build(P, tsm.WALK_STEP),
                 lambda dev: pack_dualgather(_lower_lanes(dev), group=4),
                 _zero_octet_slab, _kt1_spmm),
    "sb_walk": (tsm.slab_walk,
                lambda P: tsm._slab_walk_build(P, tsm.WALK_STEP),
                lambda dev: pack_dualgather(_lower_lanes(dev), group=4,
                                            k_tiles=2, two_win=True),
                _zero_octet_slab, _kt1_spmm),
    "fused_walk": (tfu.fused_walk, tfu._walk_build, _fused_plan,
                   _zero_gated_slot, tfu.fused_forward_plain),
}


@pytest.mark.parametrize("name", list(CASES))
def test_read_keeps_the_entry(name):
    get, _, pack, _, _ = CASES[name]
    P = pack("cpu")
    first = get(P)
    P.vals.sum(), P.vals.clone(), P.vals[0].tolist()
    assert get(P) is first


@pytest.mark.parametrize("name", list(CASES))
def test_in_place_write_rebuilds(name):
    """The entry is built anew, as a fresh build; the write moves y (so
    a kernel that kept the old entry would miss it)."""
    get, build, pack, cell, plain = CASES[name]
    P = pack("cpu")
    first = get(P)
    assert _same(first, build(P))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        P.shape[1]).astype(np.float32))
    y = plain(P, x)
    g, row, lane = cell(P)
    P.vals[g, row, lane] = 7.0
    assert not torch.equal(plain(P, x), y)
    second = get(P)
    assert second is not first
    assert _same(second, build(P)) and not _same(second, first)
    assert get(P) is second


def test_write_grows_the_structures():
    """The write's slab and sector come into the structures: the mask's
    bit, the group's real count, the octet walk's item."""
    P = pack_sell_rowlane(_lower_lanes(), group=8)
    g, row, lane = _zero_sector(P)
    slab = g * P.group + row // 8
    assert int(trl.sector_mask(P)[slab, 0]) & (1 << (lane // 8)) == 0
    P.vals[g, row, lane] = 1.0
    assert int(trl.sector_mask(P)[slab, 0]) & (1 << (lane // 8)) != 0
    g, row, lane = _padding_slab(P)
    before = int(trl.group_real(P)[g])
    P.vals[g, row, lane] = 1.0
    assert int(trl.group_real(P)[g]) == P.group > before
    A = pack_octet(_sparse_rows(), group=8, k_octets=2)
    n_items = toc.octet_walk(A)[0].shape[0]
    g, row, lane = _zero_octet_slab(A)
    A.vals[g, row, lane] = 1.0
    assert toc.octet_walk(A)[0].shape[0] == n_items + 1


def test_cached_on_version():
    """A generic entry: built once a version of its values."""
    class Box:
        def __init__(self):
            self.t = torch.zeros(4)

    cache, calls = {}, []

    def build(box):
        calls.append(1)
        return box.t.clone()

    A = Box()
    get = lambda: cached_on(cache, A, build, values_version(A.t))  # noqa
    first = get()
    assert get() is first and len(calls) == 1
    A.t[1] = 2.0
    assert float(get()[1]) == 2.0 and len(calls) == 2
    A.t.mul_(3.0)
    assert float(get()[1]) == 6.0 and len(calls) == 3
    A.t.view(2, 2)[0, 0] = 1.0  # a write through a view moves it too
    assert float(get()[0]) == 1.0 and len(calls) == 4
    del A
    assert not cache


def test_values_version_of_inference_tensors():
    with torch.inference_mode():
        t = torch.ones(3)
    assert values_version(t, torch.ones(2)) == (None, 0)


def _local_cases():
    import sparsematrix_tpu_torch.parallel as par
    from sparsematrix_tpu_torch.parallel import dist_dualgather, dist_rowlane

    return {
        "dualgather": (lambda A: par.partition_dualgather(A, 1, group=4),
                       dist_dualgather._local_dg_of, dist_dualgather.local_dg,
                       _kt1_spmm),
        "rowlane": (lambda A: par.partition_rowlane(A, 1, group=8),
                    dist_rowlane._local_sell_of, dist_rowlane.local_sell,
                    spmv_sell_rowlane_reference)}


@pytest.mark.parametrize("name", ["dualgather", "rowlane"])
def test_local_pack_follows_partition_writes(name):
    """A rank's local pack of a partition (``dist_spmm_dualgather``'s and
    ``dist_spmv_rowlane``'s, cached a partition and rank; on the card a
    copy of the host planes) is made anew after an in-place write into
    the partition's values, as a fresh slice; a read keeps it."""
    from sparsematrix_tpu_torch.parallel import shard_partitioned
    from sparsematrix_tpu_torch.parallel.mesh import Mesh

    partition, local_of, local, plain = _local_cases()[name]
    mesh = Mesh(("shard",), (None,), (0,), (1,), torch.device("cpu"))
    part = partition(_lower_lanes())
    first = local_of(part, mesh, "shard")
    part.vals.sum()
    assert local_of(part, mesh, "shard") is first
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        part.shape[1]).astype(np.float32))
    y = plain(first, x)
    nz = torch.nonzero(part.vals[0])[0]
    part.vals[(0, *nz.tolist())] += 500.0
    second = local_of(part, mesh, "shard")
    assert second is not first
    assert _same(second, local(part, shard_partitioned(part, mesh, "shard")))
    assert not torch.equal(plain(second, x), y)
    assert local_of(part, mesh, "shard") is second
