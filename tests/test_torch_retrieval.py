"""Port vs reference: banded LSH retrieval — band keys straight from the
packed bytes, kernel B10 (packed Hamming distance), ``hamming_topk`` and
``BandedLSHIndex``.

On the CPU the port's Hamming wrapper runs its plain version; its
distances must equal the reference's Pallas kernel (interpret mode) and
its XLA twin exactly, and ``hamming_topk`` / ``BandedLSHIndex.query``
must return the reference's ids, ties included (the lower index first),
and its float32 sims bit for bit.  The CUDA kernel itself is tested in
test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.bbit import pack_codes
from repro.core.schemes import make_scheme as j_make_scheme
from repro.data.packing import pad_rows
from repro.kernels import ops as jops
from repro.kernels.hamming import (hamming_distance_pallas,
                                   hamming_distance_xla)
from repro.retrieval import BandedLSHIndex as JIndex
from repro.retrieval import bands as jbands

from repro_torch.kernels import hamming as thd
from repro_torch.kernels import ops
from repro_torch.retrieval import BandedLSHIndex
from repro_torch.retrieval import bands as tbands


def _codes(n, k, b, seed=0):
    rng = np.random.default_rng(seed * 7919 + k * 31 + b)
    return rng.integers(0, 1 << b, size=(n, k)).astype(np.uint16)


def _with_ties(n, k, b, seed):
    """Packed rows with exact duplicates of row 0 and of each other, so
    equal distances compete for the top slots."""
    codes = _codes(n, k, b, seed)
    codes[[4, 9, 17]] = codes[0]
    codes[[5, 6, 30]] = codes[2]
    near = codes[0].copy()
    near[0] ^= 1
    codes[[11, 12]] = near
    return pack_codes(codes, b)


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.dtype == want.dtype == np.float32
            and np.array_equal(got.view(np.uint32), want.view(np.uint32)))


# ---------------------------------------------------------------------------
# band keys
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 12])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_band_keys_match_reference(b, r):
    k = 24
    codes = _codes(17, k, b, seed=b * 10 + r)
    packed = pack_codes(codes, b)
    got = tbands.band_keys_packed(packed, k, b, r)
    assert got.dtype == np.uint64 and got.shape == (17, k // r)
    assert np.array_equal(got, jbands.band_keys_packed(packed, k, b, r))
    assert np.array_equal(got, tbands.band_keys_ref(codes, b, r))
    assert np.array_equal(tbands.band_keys_ref(codes, b, r),
                          jbands.band_keys_ref(codes, b, r))


def test_band_geometry_and_signature_match_reference():
    for args in ((24, 8, 4), (30, 12, 3), (16, 1, 16)):
        assert tbands.band_geometry(*args) == jbands.band_geometry(*args)
    for bad in ((24, 8, 0), (24, 8, 5), (16, 8, 8)):
        with pytest.raises(ValueError):
            tbands.band_geometry(*bad)
        with pytest.raises(ValueError):
            jbands.band_geometry(*bad)
    row = pack_codes(_codes(1, 32, 4, seed=3), 4)[0]
    for probe in (None, 1, 3):
        assert (tbands.band_signature(row, 32, 4, 2, probe)
                == jbands.band_signature(row, 32, 4, 2, probe))
    with pytest.raises(ValueError):
        tbands.band_signature(row, 32, 4, 2, 0)
    with pytest.raises(ValueError, match="packed shape"):
        tbands.band_keys_packed(row[None, :-1], 32, 4, 2)


# ---------------------------------------------------------------------------
# B10 and hamming_topk
@pytest.mark.parametrize("k,b", [(32, 1), (32, 2), (32, 4), (32, 8),
                                 (37, 8), (30, 12), (256, 8)])
def test_hamming_plain_matches_pallas_and_xla(k, b):
    packed = _with_ties(50, k, b, seed=b)
    q = packed[11]
    want = np.asarray(hamming_distance_pallas(jnp.asarray(q),
                                              jnp.asarray(packed),
                                              interpret=True))
    assert np.array_equal(want, np.asarray(hamming_distance_xla(
        jnp.asarray(q), jnp.asarray(packed))))
    got = thd.hamming_distance(torch.from_numpy(q), torch.from_numpy(packed))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got[11] == 0


def test_hamming_distance_refuses_bad_shapes():
    q = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 query"):
        thd.hamming_distance(q, torch.zeros((3, 7), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8 query"):
        thd.hamming_distance(q, torch.zeros((3, 8), dtype=torch.int32))


@pytest.mark.parametrize("k,b,topk", [(32, 4, 10), (64, 8, 5), (37, 8, 10),
                                      (24, 3, 10), (32, 2, 200), (256, 8, 10),
                                      (30, 12, 10)])
def test_hamming_topk_matches_reference_with_ties(k, b, topk):
    packed = _with_ties(60, k, b, seed=k + b)
    for q in (packed[0], packed[2], packed[11], packed[45]):
        want_i, want_s = jops.hamming_topk(jnp.asarray(q),
                                           jnp.asarray(packed), k=k, bits=b,
                                           topk=topk)
        ops.reset_counts()
        got_i, got_s = ops.hamming_topk(torch.from_numpy(q),
                                        torch.from_numpy(packed), k=k,
                                        bits=b, topk=topk)
        assert ops.counts()["hamming_distance_plain"] == 1
        assert ops.counts()["hamming_distance"] == 0
        assert got_i.dtype == torch.int32
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert _same_bits(got_s.numpy(), np.asarray(want_s))
    # the duplicates of row 0 come back in index order, all at sim 1
    got_i, got_s = ops.hamming_topk(torch.from_numpy(packed[0]),
                                    torch.from_numpy(packed), k=k, bits=b,
                                    topk=4)
    assert got_i.tolist() == [0, 4, 9, 17] and bool((got_s == 1.0).all())


# ---------------------------------------------------------------------------
# BandedLSHIndex
def _pair(k, b, r):
    return (BandedLSHIndex(k=k, b=b, rows_per_band=r, device="cpu"),
            JIndex(k=k, b=b, rows_per_band=r))


def _same_query(tidx, jidx, q, **kw):
    got_ids, got_s = tidx.query(q, **kw)
    want_ids, want_s = jidx.query(q, **kw)
    assert got_ids == want_ids
    assert _same_bits(got_s, np.asarray(want_s))
    return got_ids, got_s


@pytest.mark.parametrize("k,b,r", [(16, 4, 2), (32, 8, 1), (24, 3, 4),
                                   (64, 8, 4)])
def test_index_insert_query_delete_matches_reference(k, b, r):
    packed = _with_ties(40, k, b, seed=r)
    tidx, jidx = _pair(k, b, r)
    ids = [f"doc{i}" for i in range(40)]
    for index in (tidx, jidx):
        index.insert(ids, packed)
    assert len(tidx) == len(jidx) == 40
    for row in (0, 2, 7, 11):
        for kw in ({"top_k": 5}, {"top_k": 3, "probe_bands": 1}):
            _same_query(tidx, jidx, packed[row], **kw)
    got_ids, got_s = _same_query(tidx, jidx, packed[0], top_k=4)
    assert got_ids == ["doc0", "doc4", "doc9", "doc17"]
    assert np.all(got_s == 1.0)
    assert tidx.candidates(packed[2]) == jidx.candidates(packed[2])

    for index in (tidx, jidx):
        assert index.delete(["doc4", "nope"]) == 1
        index.insert(["doc9"], packed[13])          # replace: delete+insert
    assert len(tidx) == len(jidx) == 39
    got_ids, _ = _same_query(tidx, jidx, packed[0], top_k=5)
    assert "doc4" not in got_ids
    assert tidx.stats() == jidx.stats()


def test_index_queries_that_find_nothing_match_reference():
    tidx, jidx = _pair(16, 4, 2)
    packed = pack_codes(_codes(5, 16, 4, seed=1), 4)
    got = tidx.query(packed[0])
    assert got[0] == [] and got[1].dtype == np.float32 and got[1].size == 0
    for index in (tidx, jidx):
        index.insert([1, 2], packed[:2])
    # a query that shares no band with anything indexed
    far = pack_codes((_codes(1, 16, 4, seed=9) ^ 0xF).astype(np.uint16), 4)
    assert tidx.candidates(far[0]) == jidx.candidates(far[0])
    with pytest.raises(ValueError, match="width"):
        tidx.query(np.zeros(3, np.uint8))
    with pytest.raises(ValueError, match="length mismatch"):
        tidx.insert([1], packed[:2])


def test_index_recall_on_near_duplicates_matches_reference():
    """OPH codes of documents and of their 8 %-churn near-duplicates:
    the port's index returns the reference's ids and sims, and finds the
    source in the top 3 of nearly every query."""
    rng = np.random.default_rng(4)
    k, b, r = 64, 4, 2
    docs = [np.unique(rng.choice(1 << 20, size=200, replace=False))
            for _ in range(48)]
    scheme = j_make_scheme("oph", k=k, seed=3)
    idx_rows, nnz = pad_rows(docs, pad_to_multiple=1)
    packed, _ = scheme.encode_packed_numpy(idx_rows, nnz, b)
    tidx, jidx = _pair(k, b, r)
    for index in (tidx, jidx):
        index.insert(list(range(len(docs))), packed)
    found = 0
    for qi in range(16):
        q_doc = docs[qi][rng.random(docs[qi].size) > 0.08]
        qi_rows, q_nnz = pad_rows([q_doc], pad_to_multiple=1)
        q_packed, _ = scheme.encode_packed_numpy(qi_rows, q_nnz, b)
        ids, _ = _same_query(tidx, jidx, q_packed[0], top_k=3)
        found += qi in ids
    assert found >= 14


def test_index_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BandedLSHIndex(k=16, b=4, rows_per_band=2)
