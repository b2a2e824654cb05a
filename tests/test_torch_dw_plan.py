"""Port vs reference: B8's plan and segment sum, B7's bin groups, and the
cache that keeps B8's plans, on the CPU.

B8 (``bbit_linear_bwd_dw``) runs on the card from a plan of its codes:
for each bin j, the rows whose code lies in [0, V), ordered by (code,
row), after which each call sums runs of dout.  B7
(``bbit_linear_fwd``) sums each bin group's partial logits and adds the
groups in order.  The CUDA kernels run only on the card
(tests/test_torch_kernels_cuda.py); here their plain twins are held to
the plain versions the CPU path takes and to the reference's Pallas
kernels in interpret mode, at 1e-5 (the sum order differs), with codes
outside [0, V) among them, which add nothing in the reference's one-hot
kernels.  The plan cache is driven with the plain plan builder."""
import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.bbit_linear import (bbit_linear_bwd_dw_pallas,
                                       bbit_linear_fwd_pallas)

from repro_torch.kernels import bbit_linear as bl
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
STRAYS = np.array([-1, -7, 0, 0], np.int64)   # offsets: -1, -7, V, V


def _codes(n, k, bits, seed, strays=0.1):
    """int32 (n, k) codes in [0, 2^bits), ``strays`` of them outside."""
    rng = np.random.default_rng(seed)
    v = 1 << bits
    codes = rng.integers(0, v, size=(n, k)).astype(np.int64)
    out = rng.random((n, k)) < strays
    pick = rng.integers(0, 4, size=int(out.sum()))
    codes[out] = np.where(pick < 2, STRAYS[pick], v + pick - 2)
    return codes.astype(np.int32)


SHAPES = [(37, 5), (1, 3), (130, 9), (16, 1)]


@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
@pytest.mark.parametrize("n,k", SHAPES)
def test_plain_plan_orders_rows_by_code_then_row(bits, n, k):
    v = 1 << bits
    codes = _codes(n, k, bits, seed=n * k + bits)
    perm, scode, offsets = bl.bbit_linear_dw_plan_plain(
        torch.from_numpy(codes), v)
    assert perm.dtype == scode.dtype == offsets.dtype == torch.int32
    assert tuple(perm.shape) == tuple(scode.shape) == (k, n)
    assert tuple(offsets.shape) == (k, 257)
    shift = 8 * (bl.dw_plan_passes(v) - 1)
    for j in range(k):
        col = codes[:, j]
        rows = np.flatnonzero((col >= 0) & (col < v))
        rows = rows[np.lexsort((rows, col[rows]))]
        m = len(rows)
        assert np.array_equal(perm[j, :m].numpy(), rows)
        assert np.array_equal(scode[j, :m].numpy(), col[rows])
        assert bool((perm[j, m:] == -1).all()) and bool((scode[j, m:] == v).all())
        digits = col[rows] >> shift
        assert np.array_equal(offsets[j].numpy(), np.searchsorted(
            digits, np.arange(257), side="left"))


@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n,k", SHAPES)
def test_plan_sum_matches_histogram_and_reference(bits, c, n, k):
    """The sum over the plain plan ≡ ``bbit_linear_bwd_dw_plain`` (what
    the CPU path runs), the reference's B8 in interpret mode and its
    one-hot oracle, strays adding nothing in all of them."""
    v = 1 << bits
    codes = _codes(n, k, bits, seed=7 * n + k + bits)
    dout = np.random.default_rng(c + bits).normal(size=(n, c)).astype(
        np.float32)
    tc, td = torch.from_numpy(codes), torch.from_numpy(dout)
    got = bl.bbit_linear_dw_sum_plain(bl.bbit_linear_dw_plan_plain(tc, v),
                                      td, v).numpy()
    np.testing.assert_array_equal(got, bl.bbit_linear_dw_sum(
        bl.bbit_linear_dw_plan(tc, v), td, v).numpy())
    assert got.shape == (k, v, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, bl.bbit_linear_bwd_dw_plain(tc, td, v)
                               .numpy(), **TOL)
    np.testing.assert_allclose(got, bl.bbit_linear_bwd_dw(tc, td, v).numpy(),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(bbit_linear_bwd_dw_pallas(
        jnp.asarray(codes), jnp.asarray(dout), v, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.bbit_linear_bwd_dw(
        jnp.asarray(codes), jnp.asarray(dout), v)), **TOL)


@pytest.mark.parametrize("bits,k,c", [(8, 37, 1), (9, 70, 1), (4, 100, 3),
                                      (16, 33, 1), (1, 6, 3)])
def test_grouped_fwd_plain_matches_gather_sum_and_reference(bits, k, c):
    """B7's order of sums (each bin group's partial logits, added in
    group order) ≡ ``gather_sum`` and the reference's B7 in interpret
    mode; strays add nothing.  Where a 32-bin slice fits L1 a group is
    32 bins, so k=37 leaves a ragged group of 5; at V=65536 one group
    holds all k."""
    v = 1 << bits
    n = 11
    rng = np.random.default_rng(bits + k + c)
    codes = _codes(n, k, bits, seed=k)
    w = rng.normal(size=(k, v, c)).astype(np.float32)
    tc, tw = torch.from_numpy(codes), torch.from_numpy(w)
    got = bl.bbit_linear_fwd_grouped_plain(tc, tw).numpy()
    assert got.shape == (n, c)
    np.testing.assert_allclose(got, bl.gather_sum(tc, tw).numpy(), **TOL)
    np.testing.assert_allclose(got, bl.bbit_linear_fwd(tc, tw).numpy(), **TOL)
    np.testing.assert_allclose(got, np.asarray(bbit_linear_fwd_pallas(
        jnp.asarray(codes), jnp.asarray(w), interpret=True)), **TOL)
    inside = np.clip(codes, 0, v - 1)
    np.testing.assert_allclose(
        bl.bbit_linear_fwd_grouped_plain(torch.from_numpy(inside), tw).numpy(),
        np.asarray(jref.bbit_linear_fwd(jnp.asarray(inside), jnp.asarray(w))),
        **TOL)


@pytest.mark.parametrize("k,v,c,want", [
    (500, 1 << 16, 1, 500),           # the paper fits: one group
    (256, 256, 1, 32),                # rcv1_oph: 8 groups of 32 bins
    (30, 4096, 1, 30),                # the abstract's k=30, b=12
    (130, 512, 1, 32),                # a 32-bin slice of 64 KiB
    (130, 256, 3, 130),               # 96 KiB: one group
    (0, 4, 1, 32),
])
def test_fwd_layout_is_a_function_of_the_shapes(k, v, c, want):
    assert bl.fwd_layout(k, v, c) == want


H100_L2 = 50 << 20


@pytest.mark.parametrize("n,k,v,c,itemsize,l2,want", [
    (541_919, 500, 1 << 16, 1, 4, H100_L2, 32),   # the TRON cell's training
    (541_919, 500, 1 << 16, 1, 2, H100_L2, 64),   # rows, float32 / bfloat16
    (135_480, 500, 1 << 16, 1, 4, H100_L2, 32),   # its test rows
    (135_480, 500, 1 << 16, 1, 2, H100_L2, 64),
    (16_000, 500, 1 << 16, 1, 4, H100_L2, 500),   # chip_smoke's: one pass
    (64, 500, 1 << 16, 1, 4, H100_L2, 500),       # a serving batch
    (98_304, 500, 1 << 16, 1, 2, H100_L2, 500),   # each value read 1.5x
    (114_687, 500, 1 << 16, 1, 4, H100_L2, 500),  # each value read < 1.75x
    (114_688, 500, 1 << 16, 1, 4, H100_L2, 32),
    (131_072, 500, 1 << 16, 1, 4, H100_L2, 32),
    (541_919, 500, 1 << 16, 3, 4, H100_L2, 32),   # C=3: one chunk at least
    (541_919, 500, 256, 1, 4, H100_L2, 500),      # the L1 path's groups
    (541_919, 100, 1 << 16, 1, 4, H100_L2, 32),   # 32, 32, 32 and 4 bins
    (541_919, 500, 4096, 1, 4, H100_L2, 500),     # 8.2 MB: inside the share
    (541_919, 500, 1 << 16, 1, 4, 2 * H100_L2, 64),   # twice the L2
    (541_919, 0, 1 << 16, 1, 4, H100_L2, 1),
])
def test_fwd_slices_is_a_function_of_the_shapes(n, k, v, c, itemsize, l2,
                                                want):
    assert bl.fwd_slices(n, k, v, c, itemsize, l2) == want


@pytest.mark.parametrize("k", [1, 31, 32, 100, 500, 4096])
@pytest.mark.parametrize("v", [2, 256, 4096, 1 << 16])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_fwd_slices_end_on_chunk_boundaries(k, v, c, itemsize):
    """Slices hold whole 32-bin chunks, so each row's logits keep the one
    pass's fixed tree a chunk and its chunk order, bit for bit; a slice's
    part of the table fits the L2 share unless it is one chunk."""
    width = bl.fwd_slices(541_919, k, v, c, itemsize, H100_L2)
    assert 1 <= width <= max(k, 1)
    if width < k:
        assert width % bl.FWD_CHUNK == 0
        assert (width == bl.FWD_CHUNK or width * v * c * itemsize
                <= bl.FWD_L2_SHARE * H100_L2)
        assert bl.fwd_layout(k, v, c) == k


@pytest.mark.parametrize("n,v,span,passes", [
    (16000, 256, 128, 1),             # rcv1_oph
    (16000, 1 << 16, 2048, 2),        # the paper fits
    (16000, 4096, 2048, 2),           # the abstract's b=12
    (100000, 256, 32, 1),
    (67, 2, 2, 1), (0, 8, 8, 1), (300, 1 << 17, 2048, 3), (5, 1, 1, 1),
])
def test_dw_sum_span_and_plan_passes(n, v, span, passes):
    assert bl.dw_sum_span(n, v) == span
    assert bl.dw_plan_passes(v) == passes


def _plain_cache(entries=2):
    return bl._DwPlanCache(entries)


def test_cache_reuses_the_plan_of_the_same_tensor():
    cache = _plain_cache()
    codes = torch.from_numpy(_codes(40, 6, 8, seed=1))
    first = cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
    again = cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
    assert cache.builds.value == 1 and len(cache) == 1
    assert again is first
    other_v = cache.get(codes, 512, bl.bbit_linear_dw_plan_plain)
    assert cache.builds.value == 2 and other_v is not first


def test_cache_rebuilds_after_an_in_place_write():
    cache = _plain_cache()
    codes = torch.from_numpy(_codes(40, 6, 8, seed=2))
    before = cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
    codes[3, 2] = 255 - codes[3, 2]                 # bumps codes._version
    after = cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
    assert cache.builds.value == 2 and len(cache) == 1
    want = bl.bbit_linear_dw_plan_plain(codes, 256)
    assert all(torch.equal(a, b) for a, b in zip(after, want))
    assert not all(torch.equal(a, b) for a, b in zip(before, after))
    view = codes.view(-1).view(40, 6)                # another object
    cache.get(view, 256, bl.bbit_linear_dw_plan_plain)
    assert cache.builds.value == 3


def test_cache_drops_the_entry_of_a_dead_tensor():
    cache = _plain_cache()
    codes = torch.from_numpy(_codes(40, 6, 8, seed=3))
    cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
    assert len(cache) == 1
    del codes
    gc.collect()
    assert len(cache) == 0


def test_a_new_tensor_never_hits_an_old_plan():
    """Tensors made and dropped in turn (their ids and buffers may be
    reused) and equal twins alive together each get their own plan,
    which is the plan of their own codes; the cache holds at most its
    bound, the least recently used going first."""
    cache = _plain_cache(entries=2)
    for seed in range(6):
        codes = torch.from_numpy(_codes(40, 6, 8, seed=10 + seed))
        got = cache.get(codes, 256, bl.bbit_linear_dw_plan_plain)
        want = bl.bbit_linear_dw_plan_plain(codes, 256)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        del codes, got
    assert cache.builds.value == 6
    a = torch.from_numpy(_codes(40, 6, 8, seed=20))
    b, c = a.clone(), a.clone()
    for t in (a, b, c):
        cache.get(t, 256, bl.bbit_linear_dw_plan_plain)
    assert cache.builds.value == 9 and len(cache) == 2
    cache.get(a, 256, bl.bbit_linear_dw_plan_plain)   # a was evicted
    assert cache.builds.value == 10
    cache.clear()
    assert len(cache) == 0


def test_the_wrappers_cache_is_bounded_and_counted_in_ops():
    assert bl._DW_PLANS.entries == bl.DW_PLAN_CACHE_ENTRIES
    assert bl.bbit_linear_bwd_dw.plan_builds is bl._DW_PLANS.builds
    bl._DW_PLANS.builds.add()
    assert ops.counts()["bbit_linear_bwd_dw_plans"] >= 1
    ops.reset_counts()
    assert ops.counts()["bbit_linear_bwd_dw_plans"] == 0
