"""Port vs reference: VW signed feature hashing (kernel B9's plain version
and ``core.vw``).

Inputs are made with numpy from a seed and fed to both packages.  With
values of ones (the experiment's case) every sketch entry is a small
integer, so the port must equal the reference exactly; with random
values the two sum in other orders and are held to atol 1e-4, the
reference's own tolerance in tests/test_kernels.py.  The CUDA kernel
itself is tested in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.vw import vw_hash_sparse as j_vw_hash_sparse
from repro.core.vw import vw_inner_product as j_vw_inner_product
from repro.kernels import ref as jref
from repro.kernels.vw_sketch import vw_sketch_pallas

from repro_torch.core.vw import vw_hash_sparse, vw_inner_product
from repro_torch.kernels import ops
from repro_torch.kernels import vw_sketch as tvw


def _batch(n, m, seed, ones=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 30, size=(n, m)).astype(np.int32)
    val = (np.ones((n, m), np.float32) if ones
           else rng.normal(size=(n, m)).astype(np.float32))
    nnz = rng.integers(1, m + 1, size=(n,)).astype(np.int32)
    return idx, val, nnz


@pytest.mark.parametrize("n,m,buckets", [
    (8, 64, 32), (12, 300, 1024), (4, 50, 4096), (1, 1, 2),
])
def test_vw_sketch_plain_matches_pallas_and_oracle(n, m, buckets):
    idx, val, nnz = _batch(n, m, seed=n + m)
    want_k = vw_sketch_pallas(jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(nnz), buckets, seed=3,
                              interpret=True)
    want_r = jref.vw_sketch(jnp.asarray(idx), jnp.asarray(val),
                            jnp.asarray(nnz), buckets, seed=3)
    got = tvw.vw_sketch(torch.from_numpy(idx), torch.from_numpy(val),
                        torch.from_numpy(nnz), buckets, seed=3).numpy()
    assert got.dtype == np.float32 and got.shape == (n, buckets)
    np.testing.assert_allclose(got, np.asarray(want_k), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want_r), atol=1e-4)


@pytest.mark.parametrize("buckets", [2, 64, 1024])
def test_vw_sketch_ones_equal_reference_exactly(buckets):
    idx, val, nnz = _batch(10, 200, seed=buckets, ones=True)
    want = jref.vw_sketch(jnp.asarray(idx), jnp.asarray(val),
                          jnp.asarray(nnz), buckets, seed=2)
    got = tvw.vw_sketch(torch.from_numpy(idx), torch.from_numpy(val),
                        torch.from_numpy(nnz), buckets, seed=2).numpy()
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("m", [64, 12])
@pytest.mark.parametrize("with_values", [False, True])
def test_vw_hash_sparse_matches_reference(s, m, with_values):
    idx, val, nnz = _batch(9, 120, seed=s * 100 + m, ones=not with_values)
    mask = np.arange(120)[None, :] < nnz[:, None]
    values = val if with_values else None
    want = np.asarray(j_vw_hash_sparse(
        jnp.asarray(idx), jnp.asarray(mask),
        None if values is None else jnp.asarray(values), m, s=s, seed=5))
    got = vw_hash_sparse(torch.from_numpy(idx), torch.from_numpy(mask),
                         None if values is None else torch.from_numpy(values),
                         m, s=s, seed=5).numpy()
    assert got.shape == (9, m)
    if with_values:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif s == 1:
        assert np.array_equal(got, want)
    else:
        # sums of ±√3 in another order: float32 rounding only
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        assert np.array_equal(got != 0, want != 0)


def test_vw_sketch_matches_core_vw_at_power_of_two():
    """B9's streams ≡ ``core.vw`` at s = 1 and a power-of-two m (the
    reference's test_vw_sketch_matches_core_vw), in the port alone and
    against the reference's core.vw."""
    idx, val, nnz = _batch(6, 40, seed=9, ones=True)
    mask = np.arange(40)[None, :] < nnz[:, None]
    got = tvw.vw_sketch(torch.from_numpy(idx), torch.from_numpy(val),
                        torch.from_numpy(nnz), 64, seed=2)
    core = vw_hash_sparse(torch.from_numpy(idx), torch.from_numpy(mask),
                          None, 64, seed=2)
    want = j_vw_hash_sparse(jnp.asarray(idx), jnp.asarray(mask), None, 64,
                            seed=2)
    assert torch.equal(got, core)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_ops_vw_sketch_dispatch_and_counters():
    """A power-of-two m on a CPU tensor and m = 12 both take the plain
    version, on the plain counter, with the reference ops' result
    (bucket = h & (m − 1), also for m = 12)."""
    from repro.kernels import ops as jops
    idx, val, nnz = _batch(5, 30, seed=1, ones=True)
    for m in (16, 12):
        ops.reset_counts()
        got = ops.vw_sketch(torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(nnz), m, seed=4)
        assert ops.counts()["vw_sketch_plain"] == 1
        assert ops.counts()["vw_sketch"] == 0
        want = jops.vw_sketch(jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(nnz), m, seed=4, interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_vw_sketch_rejects_non_power_of_two():
    idx, val, nnz = _batch(2, 4, seed=0)
    with pytest.raises(ValueError, match="power-of-two"):
        tvw.vw_sketch(torch.from_numpy(idx), torch.from_numpy(val),
                      torch.from_numpy(nnz), 12)


def test_vw_inner_product_matches_reference():
    rng = np.random.default_rng(4)
    g1 = rng.normal(size=(5, 32)).astype(np.float32)
    g2 = rng.normal(size=(5, 32)).astype(np.float32)
    got = vw_inner_product(torch.from_numpy(g1), torch.from_numpy(g2))
    want = j_vw_inner_product(jnp.asarray(g1), jnp.asarray(g2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
