"""The row-lane SpMM of the port (``kernels/spmm_rowlane.py``, table row
8) against the JAX package.

On the CPU the wrapper runs its plain version.  It must agree with an
fp64 oracle at the JAX tests' tolerance (``tests/test_spmm_rowlane.py``:
rtol 2e-3, atol 0.5, values in ±1000) on the JAX test's shapes and
densities at k ∈ {1, 8, 32}, with fp32 and bf16 packs (a bf16 pack against
the oracle of its bf16-rounded values) and fp32 and bf16 X; and, in the
cases marked ``jax`` (one a shape class: the Pallas kernel in interpret
mode compiles for seconds a case), with the JAX ``spmm_rowlane`` at the
same tolerance.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparsematrix_tpu.formats as jf
import sparsematrix_tpu_torch as smt
from sparsematrix_tpu.kernels.spmm_rowlane import spmm_rowlane as jax_spmm
from sparsematrix_tpu.kernels.spmv_rowlane import pack_sell_rowlane as jpack
from sparsematrix_tpu_torch.kernels import _build
from sparsematrix_tpu_torch.kernels.spmm_rowlane import (
    spmm_rowlane, spmm_rowlane_reference)
from sparsematrix_tpu_torch.utils.testutils import gen_random_dense_sparse

TOL = dict(rtol=2e-3, atol=0.5)
# the JAX test's shapes and densities (test_spmm_rowlane.py:11-15)
SHAPES = {"96x1024": ((96, 1024), 0.05), "200x2048": ((200, 2048), 0.02),
          "130x1500": ((130, 1500), 0.03)}


@functools.lru_cache(maxsize=None)
def matrix(name):
    rng = np.random.default_rng(len(name))
    if name == "untouched":
        # three row tiles, the middle one (rows 128..255) empty
        dense = gen_random_dense_sparse(rng, 300, 1100, density=0.03)
        dense[128:256] = 0
    else:
        shape, density = SHAPES[name]
        dense = gen_random_dense_sparse(rng, *shape, density=density)
    return sps.csr_matrix(dense)


def rhs(cols, k, seed=1):
    return np.random.default_rng(seed).standard_normal((cols, k)).astype(
        np.float32)


def port_pack(sp, dtype=None, **kw):
    return smt.pack_sell_rowlane(smt.CSR.from_scipy(sp, device="cpu"),
                                 group=4, dtype=dtype, **kw)


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_fp64(name, k):
    sp = matrix(name)
    X = rhs(sp.shape[1], k)
    _build.launch_counts.clear()
    Y = spmm_rowlane(port_pack(sp), torch.from_numpy(X))
    assert Y.dtype == torch.float32 and Y.shape == (sp.shape[0], k)
    np.testing.assert_allclose(Y.numpy(), sp.astype(np.float64) @ X, **TOL)
    assert sum(_build.launch_counts.values()) == 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_matches_jax(name):
    """jax: one case a shape class, k = 8, fp32."""
    sp = matrix(name)
    X = rhs(sp.shape[1], 8)
    want = np.asarray(jax_spmm(jpack(jf.CSR.from_scipy(sp), group=4),
                               jnp.asarray(X)))
    got = spmm_rowlane(port_pack(sp), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_pack_matches_jax_and_fp64():
    """jax: a bf16 pack with fp32 X; the oracle takes the bf16-rounded
    values (accumulation stays fp32)."""
    sp = matrix("200x2048")
    X = rhs(sp.shape[1], 32)
    got = spmm_rowlane(port_pack(sp, dtype=torch.bfloat16),
                       torch.from_numpy(X)).numpy()
    rounded = sp.astype(np.float64)
    rounded.data = torch.from_numpy(sp.data).bfloat16().double().numpy()
    np.testing.assert_allclose(got, rounded @ X, **TOL)
    want = np.asarray(jax_spmm(
        jpack(jf.CSR.from_scipy(sp), group=4, dtype=jnp.bfloat16),
        jnp.asarray(X)))
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_x_matches_fp64():
    """bf16 X: the products in fp32 from the bf16 values of X."""
    sp = matrix("130x1500")
    X = torch.from_numpy(rhs(sp.shape[1], 8)).bfloat16()
    got = spmm_rowlane(port_pack(sp), X).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, sp.astype(np.float64)
                               @ X.double().numpy(), **TOL)


def test_untouched_tile_is_zero_and_matches_jax():
    """jax: a row tile that no group touches comes out zero."""
    sp = matrix("untouched")
    pk = port_pack(sp)
    assert not bool(pk.tile_nonempty[1])
    assert 1 not in set(pk.group_tile.tolist())
    X = rhs(sp.shape[1], 8)
    got = spmm_rowlane(pk, torch.from_numpy(X)).numpy()
    assert not got[128:256].any()
    np.testing.assert_allclose(got, sp.astype(np.float64) @ X, **TOL)
    want = np.asarray(jax_spmm(jpack(jf.CSR.from_scipy(sp), group=4),
                               jnp.asarray(X)))
    np.testing.assert_allclose(got, want, **TOL)


def test_padding_groups_add_nothing():
    """Zero-valued padding groups pointing at the last tile (the
    ``partition_rowlane`` padding) leave the product unchanged."""
    sp = matrix("96x1024")
    pk = port_pack(sp)
    n_pad = 3
    gh = pk.s_idx.shape[1]
    padded = dataclasses.replace(
        pk,
        s_idx=torch.cat([pk.s_idx, torch.full((n_pad, gh, 128), 77,
                                              dtype=torch.int8)]),
        vals=torch.cat([pk.vals, torch.zeros((n_pad, gh, 128))]),
        group_tile=torch.cat([pk.group_tile,
                              pk.group_tile[-1:].repeat(n_pad)]),
        slab_win=torch.cat([pk.slab_win, torch.zeros((n_pad, pk.group),
                                                     dtype=torch.int32)]))
    X = torch.from_numpy(rhs(sp.shape[1], 8))
    assert torch.equal(spmm_rowlane(padded, X), spmm_rowlane(pk, X))


def test_refuses_multilane_pack():
    sp = matrix("96x1024")
    pk = port_pack(sp, lanes_per_row=2)
    with pytest.raises(ValueError, match="lanes_per_row=1"):
        spmm_rowlane(pk, torch.zeros((sp.shape[1], 4)))
    with pytest.raises(ValueError, match="lanes_per_row=1"):
        spmm_rowlane_reference(pk, torch.zeros((sp.shape[1], 4)))


def test_refuses_spilled_pack():
    d = np.zeros((64, 256), np.float32)
    d[3, :] = 1.0  # one dense row: 256 entries of one row in 2 chunks
    pk = port_pack(sps.csr_matrix(d), spill_depth=1)
    assert pk.spill is not None and pk.spill.nnz
    with pytest.raises(ValueError, match="spilled"):
        spmm_rowlane(pk, torch.zeros((256, 4)))
