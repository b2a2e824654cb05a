"""The port's estimators, expansion, compact indexing, random projections
and ``SparseBatch`` against the reference (``tests/test_estimators.py``'s
and ``tests/test_expansion_compact.py``'s cases, on the port's hashing).

``core/estimators.py`` is a numpy copy: every law gives the reference's
floats.  Integer outputs are equal (expansion offsets, compact-index
buckets and signs, the random-projection entries r_ij, the min-hashes of
a ``SparseBatch``); float sums are allclose (1e-6 for the projections,
whose entries are the same ±1/0 and √s values summed in another order).
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp

from repro.core import estimators as jest
from repro.core.expansion import compact_index as j_compact_index
from repro.core.expansion import expand as j_expand
from repro.core.expansion import expansion_offsets as j_offsets
from repro.core.expansion import linear_forward as j_linear_forward
from repro.core.expansion import pb_hat as j_pb_hat
from repro.core.minhash import minhash_batch as j_minhash_batch
from repro.core.random_projection import _r_ij as j_r_ij
from repro.core.random_projection import rp_project_sparse as j_rp_sparse
from repro.core.types import SparseBatch as JSparseBatch
from repro.core.types import resemblance as j_resemblance
from repro.core.universal_hash import MultiplyShiftHash as JMultiplyShift

from repro_torch.core import estimators as est
from repro_torch.core.bbit import bbit_codes
from repro_torch.core.expansion import (compact_index, expand,
                                        expansion_offsets, linear_forward,
                                        pb_hat)
from repro_torch.core.minhash import minhash_batch
from repro_torch.core.random_projection import (_r_ij, rp_inner_product,
                                                rp_project_batch,
                                                rp_project_sparse)
from repro_torch.core.types import SparseBatch, resemblance
from repro_torch.core.universal_hash import MultiplyShiftHash
from repro_torch.core.vw import vw_hash_batch, vw_inner_product

CPU = "cpu"


def _make_pair(rng, dim, f1, f2, overlap):
    common = rng.choice(dim, size=f1 + f2 - overlap, replace=False)
    s1 = set(int(x) for x in common[:f1])
    s2 = set(int(x) for x in common[f1 - overlap:])
    return s1, s2


def _batch(s1, s2, dim):
    return SparseBatch.from_lists([sorted(s1), sorted(s2)], dim=dim,
                                  device=CPU)


# ---------------------------------------------------------------------------
# the paper's laws (tests/test_estimators.py), on the port's hashing
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(
    f1=st.integers(80, 400), f2=st.integers(80, 400),
    frac=st.floats(0.1, 0.9), seed=st.integers(0, 2**31 - 1),
)
def test_minwise_estimator_unbiased(f1, f2, frac, seed):
    rng = np.random.default_rng(seed)
    overlap = max(1, int(frac * min(f1, f2)))
    s1, s2 = _make_pair(rng, 1 << 16, f1, f2, overlap)
    r = resemblance(s1, s2)
    assert r == j_resemblance(s1, s2)
    k = 1500
    fam = MultiplyShiftHash.make(k, seed)
    batch = _batch(s1, s2, 1 << 16)
    z = minhash_batch(batch, fam).numpy()
    jbatch = JSparseBatch.from_lists([sorted(s1), sorted(s2)], dim=1 << 16)
    assert np.array_equal(
        z, np.asarray(j_minhash_batch(jbatch, JMultiplyShift.make(k, seed))))
    r_hat = float(np.mean(z[0] == z[1]))
    # Eq (1)/(2): within 5 sigma
    assert abs(r_hat - r) < 5 * np.sqrt(est.var_rm(r, k)) + 1e-9


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_theorem1_collision_law(b):
    rng = np.random.default_rng(b)
    s1, s2 = _make_pair(rng, 1 << 16, 500, 400, 200)
    r = resemblance(s1, s2)
    k = 3000
    fam = MultiplyShiftHash.make(k, seed=7)
    z = minhash_batch(_batch(s1, s2, 1 << 16), fam)
    codes = bbit_codes(z, b).numpy()
    pb = float(np.mean(codes[0] == codes[1]))
    pb_theory = est.bbit_law_sparse_limit(b)(r)
    assert pb_theory == jest.bbit_law_sparse_limit(b)(r)
    sigma = np.sqrt(pb_theory * (1 - pb_theory) / k)
    assert abs(pb - pb_theory) < 5 * sigma
    law = est.BBitLaw(b=b, r1=len(s1) / 2**32, r2=len(s2) / 2**32)
    assert abs(law.pb(r) - pb_theory) < 1e-6


def test_var_rb_formula_matches_simulation():
    rng = np.random.default_rng(0)
    s1, s2 = _make_pair(rng, 1 << 16, 300, 300, 150)
    r = resemblance(s1, s2)
    b, k = 2, 200
    law = est.BBitLaw(b=b, r1=0.0, r2=0.0)
    batch = _batch(s1, s2, 1 << 16)
    r_hats = []
    for seed in range(400):
        z = minhash_batch(batch, MultiplyShiftHash.make(k, seed))
        codes = bbit_codes(z, b).numpy()
        r_hats.append(law.r_hat(float(np.mean(codes[0] == codes[1]))))
    assert abs(np.mean(r_hats) - r) < 0.02          # Eq (6) unbiased
    theory = law.var_rb(r, k)
    assert 0.6 * theory < np.var(r_hats) < 1.6 * theory   # Eq (7)


@pytest.mark.parametrize("s", [1, 3])
def test_vw_unbiased_and_variance(s):
    rng = np.random.default_rng(1)
    s1, s2 = _make_pair(rng, 4096, 500, 400, 250)
    u1 = np.zeros(4096, np.float32); u1[list(s1)] = 1
    u2 = np.zeros(4096, np.float32); u2[list(s2)] = 1
    a = float(u1 @ u2)
    batch = _batch(s1, s2, 4096)
    ests = [float(vw_inner_product(*vw_hash_batch(batch, m=256, s=s,
                                                  seed=i)))
            for i in range(300)]
    se = np.sqrt(est.var_vw(u1, u2, 256, s) / 300)
    assert abs(np.mean(ests) - a) < 5 * se       # Eq (15)
    theory = est.var_vw(u1, u2, 256, s)          # Eq (16)
    assert 0.5 * theory < np.var(ests) < 1.8 * theory


def test_rp_unbiased_and_variance():
    rng = np.random.default_rng(2)
    s1, s2 = _make_pair(rng, 4096, 600, 500, 300)
    u1 = np.zeros(4096, np.float32); u1[list(s1)] = 1
    u2 = np.zeros(4096, np.float32); u2[list(s2)] = 1
    a = float(u1 @ u2)
    batch = _batch(s1, s2, 4096)
    ests = [float(rp_inner_product(*rp_project_batch(batch, k=256,
                                                     seed=i)))
            for i in range(300)]
    se = np.sqrt(est.var_rp(u1, u2, 256, 1.0) / 300)
    assert abs(np.mean(ests) - a) < 5 * se       # Eq (12)
    theory = est.var_rp(u1, u2, 256, 1.0)        # Eq (13)
    assert 0.5 * theory < np.var(ests) < 1.8 * theory


def test_vw_equals_rp_variance_at_s1():
    """Paper §5.2: at s=1, Eq (16) reduces to Eq (13)."""
    rng = np.random.default_rng(3)
    u1 = rng.normal(size=512).astype(np.float32)
    u2 = rng.normal(size=512).astype(np.float32)
    assert np.isclose(est.var_vw(u1, u2, 64, 1.0), est.var_rp(u1, u2, 64, 1.0))


def test_storage_equivalence_math():
    """Paper §5.3: same-storage comparison used in Figs 5-6."""
    assert est.storage_equivalent_k_vw(200, 8) == 50     # 1600 bits / 32
    assert est.storage_equivalent_k_vw(30, 12) == 11


@pytest.mark.parametrize("b,r1,r2", [(1, 0.0, 0.0), (2, 0.01, 0.3),
                                     (8, 0.2, 0.2), (16, 1e-6, 0.5)])
def test_laws_equal_the_reference(b, r1, r2):
    """The numpy copy gives the reference's floats for every law."""
    law, jlaw = est.BBitLaw(b=b, r1=r1, r2=r2), jest.BBitLaw(b=b, r1=r1,
                                                             r2=r2)
    for name in ("A1", "A2", "C1", "C2"):
        assert getattr(law, name) == getattr(jlaw, name)
    for R in (0.0, 0.3, 0.9):
        assert law.pb(R) == jlaw.pb(R)
        assert law.var_rb(R, 200) == jlaw.var_rb(R, 200)
        assert est.var_rm(R, 77) == jest.var_rm(R, 77)
    assert law.r_hat(0.4) == jlaw.r_hat(0.4)
    rng = np.random.default_rng(b)
    u1, u2 = rng.normal(size=(2, 64)).astype(np.float32)
    assert est.var_rp(u1, u2, 8, 3.0) == jest.var_rp(u1, u2, 8, 3.0)
    assert est.var_vw(u1, u2, 8, 3.0) == jest.var_vw(u1, u2, 8, 3.0)
    assert (est.storage_equivalent_k_vw(500, b)
            == jest.storage_equivalent_k_vw(500, b))


# ---------------------------------------------------------------------------
# the expansion and compact indexing (tests/test_expansion_compact.py)
# ---------------------------------------------------------------------------
@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 8), k=st.integers(1, 24), b=st.integers(1, 8),
       o=st.integers(1, 4), seed=st.integers(0, 1 << 30))
def test_gather_forward_equals_expansion_dot(n, k, b, o, seed):
    """w·x over the virtual 2^b·k expansion == k gathers (paper §3), and
    both equal the reference's."""
    rng = np.random.default_rng(seed)
    codes_np = rng.integers(0, 1 << b, (n, k)).astype(np.uint16)
    w_np = rng.normal(size=(k, 1 << b, o)).astype(np.float32)
    codes, w = torch.from_numpy(codes_np.astype(np.int32)), torch.from_numpy(
        w_np)
    e = expand(codes, b)
    assert np.array_equal(e.numpy(), np.asarray(j_expand(jnp.asarray(
        codes_np), b)))
    lhs = e @ w.reshape(k * (1 << b), o)
    rhs = linear_forward(codes, w, b)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-4)
    np.testing.assert_allclose(
        rhs.numpy(), np.asarray(j_linear_forward(jnp.asarray(codes_np),
                                                 jnp.asarray(w_np), b)),
        rtol=1e-6, atol=1e-6)


def test_expansion_has_exactly_k_ones():
    rng = np.random.default_rng(0)
    c1 = rng.integers(0, 16, (5, 30)).astype(np.uint16)
    c2 = rng.integers(0, 16, (5, 30)).astype(np.uint16)
    t1, t2 = (torch.from_numpy(c.astype(np.int32)) for c in (c1, c2))
    e, e2 = expand(t1, 4), expand(t2, 4)
    assert np.all(e.sum(dim=1).numpy() == 30)
    dots = (e * e2).sum(dim=1).numpy()
    pb = pb_hat(t1, t2).numpy()
    assert np.array_equal(pb, np.asarray(j_pb_hat(jnp.asarray(c1),
                                                  jnp.asarray(c2))))
    np.testing.assert_allclose(dots, 30 * pb, atol=1e-5)


def test_expansion_offsets_disjoint_blocks():
    codes = torch.tensor([[0, 3], [1, 2]], dtype=torch.int32)
    offs = expansion_offsets(codes, 2)
    assert offs.dtype == torch.int32
    assert offs.tolist() == [[0, 7], [1, 6]]
    rng = np.random.default_rng(4)
    big = rng.integers(0, 1 << 16, (7, 500)).astype(np.uint16)
    assert np.array_equal(
        expansion_offsets(torch.from_numpy(big.astype(np.int32)), 16).numpy(),
        np.asarray(j_offsets(jnp.asarray(big), 16)))


@pytest.mark.parametrize("k,b,m", [(64, 12, 512), (500, 16, 1 << 14),
                                   (30, 3, 7)])
def test_compact_index_equals_the_reference(k, b, m):
    """Buckets and signs are the reference's: the sketches are equal (sums
    of ±1)."""
    rng = np.random.default_rng(k + b)
    codes = rng.integers(0, 1 << b, (9, k)).astype(np.int32)
    for seed in range(3):
        kw = dict(seed_a=seed * 2 + 1, seed_b=seed * 7 + 3)
        got = compact_index(torch.from_numpy(codes), b, m, **kw).numpy()
        want = np.asarray(j_compact_index(jnp.asarray(codes), b, m, **kw))
        assert np.array_equal(got, want)
    assert np.array_equal(
        compact_index(torch.from_numpy(codes), b, m).numpy(),
        np.asarray(j_compact_index(jnp.asarray(codes), b, m)))


def test_compact_index_preserves_inner_products():
    """§5.4: VW over the virtual expansion is unbiased for k·P̂_b."""
    rng = np.random.default_rng(1)
    k, b, m = 64, 12, 512
    c1 = rng.integers(0, 1 << b, (1, k)).astype(np.int32)
    c2 = c1.copy()
    flip = rng.choice(k, size=k // 2, replace=False)
    c2[0, flip] = (c2[0, flip] + 1) % (1 << b)
    t1, t2 = torch.from_numpy(c1), torch.from_numpy(c2)
    true_dot = float(k * pb_hat(t1, t2)[0])
    ests = []
    for seed in range(300):
        s1 = compact_index(t1, b, m, seed_a=seed * 2 + 1, seed_b=seed * 7 + 3)
        s2 = compact_index(t2, b, m, seed_a=seed * 2 + 1, seed_b=seed * 7 + 3)
        ests.append(float((s1 * s2).sum()))
    assert abs(np.mean(ests) - true_dot) < 0.15 * k


# ---------------------------------------------------------------------------
# random projections: the entries, the projections
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 3, 16])
@pytest.mark.parametrize("seed", [0, 5, (1 << 31) + 9])
def test_rp_entries_equal_the_reference(s, seed):
    rng = np.random.default_rng(s)
    ids = rng.integers(0, 1 << 31, size=(3, 40)).astype(np.int32)
    j = np.arange(300, dtype=np.uint32)
    got = _r_ij(torch.from_numpy(ids), torch.from_numpy(j.astype(np.int64)),
                s, seed).numpy()
    want = np.asarray(j_r_ij(jnp.asarray(ids), jnp.asarray(j), s, seed))
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,s,j_chunk", [(256, 1, 128), (100, 3, 128),
                                         (7, 1, 4), (300, 2, 64)])
@pytest.mark.parametrize("weighted", [False, True])
def test_rp_projection_allclose_to_the_reference(k, s, j_chunk, weighted):
    rng = np.random.default_rng(k + s)
    rows = [rng.choice(1 << 20, size=int(n), replace=False)
            for n in rng.integers(0, 60, size=6)]
    vals = ([rng.normal(size=len(r)).astype(np.float32) for r in rows]
            if weighted else None)
    batch = SparseBatch.from_lists(rows, dim=1 << 20, values=vals,
                                   device=CPU)
    jb = JSparseBatch.from_lists(rows, dim=1 << 20, values=vals)
    got = rp_project_sparse(batch.indices, batch.mask, batch.values, k=k,
                            s=s, seed=3, j_chunk=j_chunk).numpy()
    want = np.array(j_rp_sparse(jb.indices, jb.mask, jb.values, k=k, s=s,
                                  seed=3, j_chunk=j_chunk))
    assert got.shape == want.shape == (6, k)
    # the same entries r_ij summed in another order: within 1e-6 of the
    # row's Σ_i |u_i r_ij| ≤ √s Σ_i |u_i|; ones and s=1 give integers
    scale = np.sqrt(s) * np.asarray(
        [np.abs(v).sum() if weighted else len(v)
         for v in (vals if weighted else rows)], np.float32)
    assert np.all(np.abs(got - want) <= 1e-6 * (1 + scale[:, None]))
    if not weighted and s == 1:
        assert np.array_equal(got, want)
    # the estimator (Eq. 12) on the same projections: a mean of k float32
    # products summed in another order, within 1e-6 of the mean of their
    # absolute values (the terms cancel)
    terms = want[:3] * want[3:]
    est_got = rp_inner_product(torch.from_numpy(want[:3]),
                               torch.from_numpy(want[3:])).numpy()
    est_want = np.asarray(jnp.mean(jnp.asarray(terms), axis=-1))
    assert np.all(np.abs(est_got - est_want)
                  <= 1e-6 * np.abs(terms).mean(axis=-1) + 1e-12)


# ---------------------------------------------------------------------------
# SparseBatch and resemblance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad,max_nnz", [(8, None), (1, None), (8, 5),
                                         (4, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_batch_from_lists_and_to_dense(pad, max_nnz, weighted):
    rng = np.random.default_rng(pad)
    rows = [sorted(rng.choice(50, size=int(n), replace=False).tolist())
            for n in (0, 3, 11, 7)]
    vals = ([rng.normal(size=len(r)).tolist() for r in rows]
            if weighted else None)
    batch = SparseBatch.from_lists(rows, dim=50, values=vals,
                                   max_nnz=max_nnz, pad_to_multiple=pad,
                                   device=CPU)
    jb = JSparseBatch.from_lists(rows, dim=50, values=vals, max_nnz=max_nnz,
                                 pad_to_multiple=pad)
    assert batch.n == jb.n and batch.max_nnz == jb.max_nnz
    assert batch.indices.dtype == torch.int32
    assert np.array_equal(batch.indices.numpy(), np.asarray(jb.indices))
    assert np.array_equal(batch.mask.numpy(), np.asarray(jb.mask))
    assert np.array_equal(batch.nnz().numpy(), np.asarray(jb.nnz()))
    assert (batch.values is None) == (jb.values is None)
    if weighted:
        assert np.array_equal(batch.values.numpy(), np.asarray(jb.values))
    assert np.array_equal(batch.to_dense().numpy(),
                          np.asarray(jb.to_dense()))


def test_sparse_batch_runs_on_the_card_by_default(monkeypatch):
    """Like every entry point of the port, ``from_lists`` places the batch
    on ``cuda:0`` unless asked for the CPU, and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseBatch.from_lists([[1, 2]], dim=4)


@pytest.mark.parametrize("a,b", [(set(), set()), ({1}, set()),
                                 ({1, 2, 3}, {2, 3, 4}), ({5}, {5})])
def test_resemblance_equals_the_reference(a, b):
    assert resemblance(a, b) == j_resemblance(a, b)
