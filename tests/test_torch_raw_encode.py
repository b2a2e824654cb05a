"""Port vs reference: the raw-minima encode — kernels B3 (minwise) and
B4 (OPH) — and everything built on it: ``encode_device`` /
``encode_padded`` of each scheme, ``preprocess_rows`` at the paper's own
k=500, b=16, the exact ``mod_prime`` family, and
``preprocess_rows_packed``.

On the CPU the port's wrappers run their plain torch versions; these
must equal the reference's Pallas kernels (interpret mode) word for
word, and the codes must equal the reference's byte for byte.  The CUDA
kernels themselves are tested in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bbit as jbbit
from repro.core import minhash as jminhash
from repro.core import oph as joph
from repro.core import universal_hash as juh
from repro.core.schemes import make_scheme as j_make_scheme
from repro.data import preprocess_rows as j_preprocess_rows
from repro.data.hashed_dataset import (
    preprocess_rows_packed as j_preprocess_rows_packed)
from repro.kernels.minhash import minhash_pallas
from repro.kernels.oph import oph_pallas

from repro_torch.core import bbit as tbbit
from repro_torch.core import minhash as tminhash
from repro_torch.core import oph as toph
from repro_torch.core import universal_hash as tuh
from repro_torch.core.schemes import make_scheme as t_make_scheme
from repro_torch.data.hashed_dataset import (preprocess_rows,
                                             preprocess_rows_packed)
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.kernels import minhash as tmh
from repro_torch.kernels import oph as toph_kernel
from repro_torch.kernels import ops

SCHEME_BITS = [(s, b) for s in ("minwise", "oph", "oph_zero")
               for b in (1, 6, 8, 12, 16) if not (s == "oph_zero" and b > 15)]


def _rows(n, m, seed):
    """Padded rows with an nnz=0 row, a 1-id row and a full row."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 31, size=(n, m)).astype(np.int32)
    nnz = rng.integers(1, m + 1, size=(n,)).astype(np.int32)
    nnz[:3] = [0, 1, m]
    return idx, nnz


def _words(n, seed, odd=False):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    return (w | 1 if odd else w).astype(np.uint32)


@pytest.fixture(scope="module")
def docs():
    rows, _ = generate_arrays(96, SynthRcv1Config(
        seed=11, topic_tokens=150, background_frac=0.35,
        max_pairs_per_doc=4000, max_triples_per_doc=2000))
    return rows


# ---------------------------------------------------------------------------
# B3, B4: plain versions vs the Pallas kernels
@pytest.mark.parametrize("k", [1, 30, 37, 128, 500])
def test_minhash_plain_matches_pallas(k):
    idx, nnz = _rows(9, 300, seed=k)
    a, b = _words(k, k, odd=True), _words(k, k + 1)
    want = np.asarray(minhash_pallas(jnp.asarray(idx), jnp.asarray(nnz),
                                     jnp.asarray(a), jnp.asarray(b),
                                     interpret=True))
    ops.reset_counts()
    got = ops.minhash(torch.from_numpy(idx), torch.from_numpy(nnz),
                      tuh.words_to_int32(a), tuh.words_to_int32(b))
    assert ops.counts()["minhash_plain"] == 1
    assert ops.counts()["minhash"] == 0
    assert got.dtype == torch.int32 and got.shape == (9, k)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.all(want[0] == 0xFFFFFFFF)           # the nnz=0 row
    direct = tmh.minhash(torch.from_numpy(idx), torch.from_numpy(nnz),
                         tuh.words_to_int32(a), tuh.words_to_int32(b))
    assert torch.equal(direct, got)


@pytest.mark.parametrize("k", [2, 64, 256])
def test_oph_plain_matches_pallas(k):
    idx, nnz = _rows(9, 200, seed=k)
    nnz[3] = 2                                     # fewer ids than bins
    a, b = _words(1, k, odd=True), _words(1, k + 1)
    want = np.asarray(oph_pallas(jnp.asarray(idx), jnp.asarray(nnz),
                                 jnp.asarray(a), jnp.asarray(b), k=k,
                                 interpret=True))
    ops.reset_counts()
    got = ops.oph(torch.from_numpy(idx), torch.from_numpy(nnz),
                  tuh.words_to_int32(a), tuh.words_to_int32(b), k)
    assert ops.counts()["oph_plain"] == 1 and ops.counts()["oph"] == 0
    assert got.dtype == torch.int32 and got.shape == (9, k)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.all(want[0] == 0xFFFFFFFF)           # the empty row


def test_oph_kernel_refuses_k_not_a_power_of_two():
    idx, nnz = _rows(3, 10, seed=0)
    a, b = tuh.words_to_int32([3]), tuh.words_to_int32([5])
    with pytest.raises(ValueError, match="power of two"):
        toph_kernel.oph(torch.from_numpy(idx), torch.from_numpy(nnz), a, b,
                        k=500)
    # so does the ops layer, in B4's plain call on the CPU, as the
    # reference's jnp path does
    ops.reset_counts()
    with pytest.raises(ValueError, match="power of two"):
        ops.oph(torch.from_numpy(idx), torch.from_numpy(nnz), a, b, 500)
    assert ops.counts()["oph_plain"] == 1


@pytest.mark.parametrize("bits", [1, 12, 16])
def test_minhash_bbit_matches_reference_ops(bits):
    from repro.kernels import ops as jops
    idx, nnz = _rows(6, 64, seed=bits)
    a, b = _words(40, bits, odd=True), _words(40, bits + 1)
    want = np.asarray(jops.minhash_bbit(jnp.asarray(idx), jnp.asarray(nnz),
                                        jnp.asarray(a), jnp.asarray(b), bits,
                                        interpret=True))
    got = ops.minhash_bbit(torch.from_numpy(idx), torch.from_numpy(nnz),
                           tuh.words_to_int32(a), tuh.words_to_int32(b),
                           bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.uint16), want)


# ---------------------------------------------------------------------------
# schemes: encode_device / encode_torch / encode_padded
@pytest.mark.parametrize("scheme,b", SCHEME_BITS)
def test_encode_padded_matches_reference(scheme, b):
    idx, nnz = _rows(8, 150, seed=b)
    nnz[3] = 5                                     # nnz < k
    want = j_make_scheme(scheme, 64, 5).encode_padded(idx, nnz, b)
    got = t_make_scheme(scheme, 64, 5).encode_padded(idx, nnz, b,
                                                     device="cpu")
    assert got.dtype == np.uint16 and got.shape == (8, 64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_encode_torch_equals_encode_device(scheme):
    idx, nnz = _rows(7, 90, seed=3)
    sch = t_make_scheme(scheme, 32, 9)
    ti, tn = torch.from_numpy(idx), torch.from_numpy(nnz)
    mask = torch.arange(90)[None, :] < tn[:, None]
    codes, empty = sch.encode_device(ti, tn, 12)
    want_codes, want_empty = j_make_scheme(scheme, 32, 9).encode_jnp(
        jnp.asarray(idx), jnp.asarray(mask.numpy()), 12)
    for got_c, got_e in (sch.encode_torch(ti, mask, 12), (codes, empty)):
        assert got_c.dtype == torch.int32
        assert np.array_equal(got_c.numpy(), np.asarray(want_codes))
        assert (got_e is None) == (want_empty is None)
        if got_e is not None:
            assert np.array_equal(got_e.numpy(), np.asarray(want_empty))


def test_oph_zero_refuses_b16():
    idx, nnz = _rows(3, 10, seed=0)
    with pytest.raises(ValueError, match="b must be <= 15"):
        t_make_scheme("oph_zero", 8, 0).encode_padded(idx, nnz, 16,
                                                      device="cpu")


def test_encode_padded_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    idx, nnz = _rows(3, 10, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_make_scheme("minwise", 8, 0).encode_padded(idx, nnz, 8)


# ---------------------------------------------------------------------------
# preprocess_rows / preprocess_rows_packed
def test_preprocess_rows_paper_config_equals_reference(docs):
    """configs/rcv1_bbit.py: k=500, b=16, minwise, multiply-shift."""
    ops.reset_counts()
    got = preprocess_rows(docs, k=500, b=16, seed=1, chunk=48,
                          device="cpu")
    assert ops.counts()["minhash_plain"] == 2
    assert ops.counts()["minhash_pack_plain"] == 0
    want = j_preprocess_rows(docs, k=500, b=16, seed=1, chunk=48)
    assert got.dtype == np.uint16 and got.shape == (96, 500)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scheme,b", [("minwise", 12), ("oph", 16),
                                      ("oph_zero", 15), ("oph", 6)])
def test_preprocess_rows_any_b_equals_reference(docs, scheme, b):
    got = preprocess_rows(docs[:40], k=64, b=b, scheme=scheme, seed=4,
                          chunk=16, device="cpu")
    want = j_preprocess_rows(docs[:40], k=64, b=b, scheme=scheme, seed=4,
                             chunk=16)
    assert np.array_equal(got, want)


def test_preprocess_rows_families_follow_the_reference(docs):
    rows = docs[:12]
    got = preprocess_rows(rows, k=20, b=8, family="mod_prime", seed=2,
                          chunk=5, device="cpu")
    assert np.array_equal(got, j_preprocess_rows(
        rows, k=20, b=8, family="mod_prime", seed=2, chunk=5))
    # make_hash_family is called without dim, as in the reference
    for fn in (preprocess_rows, j_preprocess_rows):
        kw = {"device": "cpu"} if fn is preprocess_rows else {}
        with pytest.raises(ValueError, match="permutation family needs dim"):
            fn(rows, k=8, b=8, family="permutation", **kw)
        with pytest.raises(ValueError, match="only supports the "
                           "multiply_shift family"):
            fn(rows, k=8, b=8, scheme="oph", family="mod_prime", **kw)


@pytest.mark.parametrize("scheme,b", [("minwise", 8), ("minwise", 6),
                                      ("oph", 4), ("oph_zero", 8),
                                      ("oph_zero", 12)])
def test_preprocess_rows_packed_equals_reference(docs, scheme, b):
    rows = docs[:37]                               # a ragged last chunk
    got, got_e = preprocess_rows_packed(rows, k=64, b=b, scheme=scheme,
                                        seed=6, chunk=16, device="cpu")
    want, want_e = j_preprocess_rows_packed(rows, k=64, b=b, scheme=scheme,
                                            seed=6, chunk=16)
    assert np.array_equal(got, want)
    assert (got_e is None) == (want_e is None)
    if want_e is not None:
        assert np.array_equal(got_e, want_e)
    codes = preprocess_rows(rows, k=64, b=b, scheme=scheme, seed=6,
                            chunk=16, device="cpu")
    codes0, _ = toph.split_zero_codes(codes)
    assert np.array_equal(got, tbbit.pack_codes(codes0, b))


# ---------------------------------------------------------------------------
# the numpy pieces: exact min-hash, OPH oracle, codes and estimators
@pytest.mark.parametrize("family", ["mod_prime", "permutation"])
def test_minhash_numpy_matches_reference(family):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1000, size=(6, 40))
    mask = rng.random((6, 40)) < 0.6
    mask[0] = False
    kw = {"dim": 1000} if family == "permutation" else {}
    tf = tuh.make_hash_family(family, 70, 3, **kw)
    jf = juh.make_hash_family(family, 70, 3, **kw)
    got = tminhash.minhash_numpy(idx, mask, tf)
    want = jminhash.minhash_numpy(idx, mask, jf)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert tminhash.collision_probability(got[1], got[2]) == \
        jminhash.collision_probability(want[1], want[2])


@pytest.mark.parametrize("b", [1, 7, 16])
def test_bbit_codes_and_storage_match_reference(b):
    rng = np.random.default_rng(b)
    z = rng.integers(0, 1 << 32, size=(5, 9), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jbbit.bbit_codes(z, b))
    assert np.array_equal(tbbit.bbit_codes(z, b), want)
    got_t = tbbit.bbit_codes(torch.from_numpy(z.astype(np.int64)), b)
    assert got_t.dtype == torch.int32
    assert np.array_equal(got_t.numpy(), want.astype(np.int32))
    assert tbbit.storage_bits(7, 500, b) == jbbit.storage_bits(7, 500, b)
    assert tbbit.vw_storage_bits(7, 500) == jbbit.vw_storage_bits(7, 500)
    c1 = rng.integers(0, 1 << b, size=(4, 30))
    c2 = np.where(rng.random((4, 30)) < 0.5, c1, rng.integers(0, 1 << b,
                                                              size=(4, 30)))
    np.testing.assert_array_equal(
        tbbit.codes_agree(torch.from_numpy(c1), torch.from_numpy(c2)).numpy(),
        np.asarray(jbbit.codes_agree(jnp.asarray(c1), jnp.asarray(c2))))
    with pytest.raises(ValueError):
        tbbit.bbit_codes(z, 17)


@pytest.mark.parametrize("densify", [True, False])
def test_oph_numpy_pieces_match_reference(densify):
    idx, nnz = _rows(8, 60, seed=int(densify))
    nnz[3] = 3
    mask = np.arange(60)[None, :] < nnz[:, None]
    tf, jf = toph.OPHHash.make(16, 5), joph.OPHHash.make(16, 5)
    tv, te = toph.oph_bin_minima_numpy(idx, mask, tf)
    jv, je = joph.oph_bin_minima_numpy(idx, mask, jf)
    assert np.array_equal(tv, jv) and np.array_equal(te, je)
    got = toph.oph_codes_numpy(idx, mask, tf, 6, densify=densify)
    want = joph.oph_codes_numpy(idx, mask, jf, 6, densify=densify)
    assert np.array_equal(got, want)
    assert toph.oph_codes_agree(got[3], got[4]) == \
        joph.oph_codes_agree(want[3], want[4])
    assert toph.oph_collision_probability(tv[3], te[3], tv[4], te[4]) == \
        joph.oph_collision_probability(jv[3], je[3], jv[4], je[4])
    # all-empty pair: the estimators' zero-denominator branch
    assert toph.oph_collision_probability(tv[0], te[0], tv[0], te[0]) == \
        joph.oph_collision_probability(jv[0], je[0], jv[0], je[0])
