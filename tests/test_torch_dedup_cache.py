"""The port's duplicate-traffic score cache on the CPU: host encode ≡
device encode (the plain versions of B1/B2 here) and ≡ the reference's
host encode byte for byte, the probe/guard/version contract, the
engine's short circuit (a hit equals a fresh score bit for bit, and
``swap_weights`` invalidates), the batch front door, ``/status`` key
coverage, and the histogram helpers the cache and batcher share (the
cases of ``tests/test_dedup_cache.py``, against the port)."""
import numpy as np
import pytest
import torch

from repro.core.schemes import make_scheme as jmake_scheme
from repro.models import linear as jlinear
from repro.serving import HashedClassifierEngine as JEngine

from repro_torch.core.schemes import make_scheme
from repro_torch.data.packing import pad_rows
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.serving import (HashedClassifierEngine, NnzHistogram,
                                 ScoreClient, ScoreServer, StatsWindow)
from repro_torch.serving.dedup import DedupCache

WAIT_S = 60


def _docs(n, seed=0, lo=5, hi=60, space=1 << 20):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.choice(space, size=int(rng.integers(lo, hi)),
                                 replace=False)).astype(np.int64)
            for _ in range(n)]


def _params(k, b, key):
    rng = np.random.default_rng(key)
    return {"table": (0.5 * rng.standard_normal((k, 1 << b, 1))
                      ).astype(np.float32),
            "bias": np.zeros((1,), np.float32)}


def _engine(scheme="oph", k=16, b=4, key=0, **kw):
    cfg = BBitLinearConfig(k=k, b=b)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("nnz_buckets", (64, 256))
    kw.setdefault("row_buckets", (1, 2, 4, 8))
    kw.setdefault("precompile", False)
    return HashedClassifierEngine(_params(k, b, key), cfg, seed=1,
                                  scheme=scheme, device="cpu", **kw)


def _with_empty(docs, scheme):
    if scheme == "oph_zero":
        docs[3] = np.array([], dtype=np.int64)   # empty-doc semantics
    return docs


# ---------------------------------------------------------------------------
# host encode ≡ device encode ≡ the reference's host encode


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [2, 8])
def test_host_encode_bitwise_matches_device(scheme, b):
    k = 16
    sch = make_scheme(scheme, k=k, seed=7)
    docs = _with_empty(_docs(12, seed=b), scheme)
    idx, nnz = pad_rows(docs, pad_to_multiple=1)
    p_host, e_host = sch.encode_packed_numpy(idx, nnz, b)
    p_dev, e_dev = sch.encode_packed(torch.from_numpy(idx),
                                     torch.from_numpy(nnz), b)
    np.testing.assert_array_equal(p_host, p_dev.numpy())
    if e_host is None:
        assert e_dev is None
    else:
        np.testing.assert_array_equal(e_host, e_dev.numpy())


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [2, 8])
def test_host_encode_matches_reference(scheme, b):
    """The port's host encode, padded and ragged, against the
    reference's ``encode_packed_numpy`` byte for byte."""
    k = 16
    docs = _with_empty(_docs(12, seed=10 + b, space=1 << 33), scheme)
    idx, nnz = pad_rows(docs, pad_to_multiple=1)
    got = make_scheme(scheme, k=k, seed=7).encode_packed_numpy(idx, nnz, b)
    want = jmake_scheme(scheme, k=k, seed=7).encode_packed_numpy(idx, nnz, b)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_dedup_keys_match_reference_engine(scheme):
    """The engine's cache keys (probe bands, packed bytes, empty bytes)
    equal the reference engine's for the same documents, ids past 2^31
    included."""
    k, b = 16, 8
    docs = _with_empty(_docs(10, seed=3, space=1 << 33), scheme)
    eng = _engine(scheme, k=k, b=b, dedup_cache=True)
    ref = JEngine(
        {n: np.asarray(v) for n, v in _params(k, b, 0).items()},
        jlinear.BBitLinearConfig(k=k, b=b), seed=1, scheme=scheme,
        precompile=False, nnz_buckets=(64, 256), dedup_cache=True)
    try:
        assert eng._dedup_keys(docs) == ref._dedup_keys(docs)
    finally:
        eng.close()
        ref.close()


def test_host_encode_is_pad_width_invariant():
    # a key computed inside any batch must equal the key computed alone
    sch = make_scheme("oph", k=16, seed=7)
    docs = _docs(6, seed=3)
    idx_all, nnz_all = pad_rows(docs, pad_to_multiple=1)
    p_all, _ = sch.encode_packed_numpy(idx_all, nnz_all, 4)
    for i, d in enumerate(docs):
        idx1, nnz1 = pad_rows([d], pad_to_multiple=1)
        p1, _ = sch.encode_packed_numpy(idx1, nnz1, 4)
        np.testing.assert_array_equal(p_all[i], p1[0])


def test_ragged_encode_matches_padded():
    sch = make_scheme("oph", k=16, seed=7)
    docs = _docs(9, seed=5)
    idx, nnz = pad_rows(docs, pad_to_multiple=1)
    p_pad, _ = sch.encode_packed_numpy(idx, nnz, 4)
    lens = np.array([d.size for d in docs], dtype=np.int64)
    tokens = (np.concatenate(docs)
              & np.int64((1 << 31) - 1)).astype(np.int32)
    p_rag, _ = sch.encode_packed_numpy_ragged(tokens, lens, 4)
    np.testing.assert_array_equal(p_pad, p_rag)


# ---------------------------------------------------------------------------
# cache unit behavior


def test_cache_guard_rejects_band_collisions():
    c = DedupCache(max_entries=8, version="v0")
    sig = (1, 2, 3)
    c.put(sig, b"codesA", None, 0.5, "v0")
    assert c.get(sig, b"codesA", None, "v0") == 0.5
    # same probe signature, different full code: guarded miss
    assert c.get(sig, b"codesB", None, "v0") is None
    st = c.stats()
    assert st["guard_rejects"] == 1 and st["hits"] == 1


def test_cache_lru_eviction_and_bytes():
    c = DedupCache(max_entries=2, version="v0")
    for i in range(3):
        c.put((i,), bytes([i]), None, float(i), "v0")
    st = c.stats()
    assert st["entries"] == 2 and st["evictions"] == 1
    assert c.get((0,), bytes([0]), None, "v0") is None   # evicted (LRU)
    assert c.get((2,), bytes([2]), None, "v0") == 2.0
    assert st["bytes"] > 0


def test_cache_version_pinning_and_stale_put():
    c = DedupCache(max_entries=8, version="v0")
    c.put((1,), b"x", None, 1.0, "v0")
    c.invalidate("v1")
    assert c.get((1,), b"x", None, "v1") is None
    c.put((1,), b"x", None, 1.0, "v0")       # late put from old version
    assert c.stats()["stale_drops"] == 1
    assert c.get((1,), b"x", None, "v1") is None


def test_get_many_matches_get():
    c1 = DedupCache(max_entries=8, version="v0")
    c2 = DedupCache(max_entries=8, version="v0")
    for c in (c1, c2):
        c.put((1,), b"a", None, 1.0, "v0")
        c.put((2,), b"b", b"m", 2.0, "v0")
    keys = [((1,), b"a", None), ((2,), b"b", b"m"),
            ((1,), b"zzz", None), ((9,), b"a", None)]
    got = c1.get_many(keys, "v0", sizes=[4, 5, 6, 7])
    want = [c2.get(s, p, e, "v0", nnz=n)
            for (s, p, e), n in zip(keys, [4, 5, 6, 7])]
    assert got == want
    for key in ("hits", "misses", "guard_rejects", "hit_nnz"):
        assert c1.stats()[key] == c2.stats()[key]


# ---------------------------------------------------------------------------
# engine short-circuit


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_engine_hit_skips_device_and_is_bitwise_identical(scheme):
    eng = _engine(scheme, dedup_cache=True, dedup_entries=64)
    docs = _with_empty(_docs(6, seed=11), scheme)
    for d in docs:
        eng.submit(d).result(timeout=WAIT_S)
    runs_before = eng.batcher.batches_run
    for d in docs:
        want = float(eng.score_docs([d])[0])
        got = float(eng.submit(d).result(timeout=WAIT_S))
        assert got == want                   # bitwise, not approx
    assert eng.batcher.batches_run == runs_before
    st = eng.dedup.stats()
    assert st["hits"] >= len(docs) and st["guard_rejects"] == 0
    assert eng.stats()["dedup"]["hits"] == st["hits"]
    eng.close()


def test_swap_weights_invalidates_cache():
    eng = _engine(dedup_cache=True, dedup_entries=64, key=0)
    d = _docs(1, seed=2)[0]
    old = float(eng.submit(d).result(timeout=WAIT_S))
    assert float(eng.submit(d).result(timeout=WAIT_S)) == old   # cached
    eng.swap_weights(_params(16, 4, key=9), "v9")
    assert eng.dedup.stats()["invalidations"] == 1
    assert eng.dedup.stats()["version"] == "v9"
    new = float(eng.submit(d).result(timeout=WAIT_S))
    assert new != old            # re-scored under the new weights
    assert new == float(eng.score_docs([d])[0])
    eng.close()


@pytest.mark.parametrize("dedup", [False, True])
def test_submit_many_matches_submit(dedup):
    eng = _engine(dedup_cache=dedup, dedup_entries=64)
    docs = _docs(10, seed=4)
    stream = docs + docs[:4]                  # duplicates in-batch
    want = [float(eng.submit(d).result(timeout=WAIT_S)) for d in stream]
    got = [float(f.result(timeout=WAIT_S))
           for f in eng.submit_many(stream)]
    if dedup:
        # every submit_many row is a cache hit on the scores the
        # submit pass just filled: bitwise, not approx
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    eng.close()


def test_submit_many_validates_like_submit():
    eng = _engine(dedup_cache=True, dedup_entries=64)
    with pytest.raises(ValueError, match="negative"):
        eng.submit_many([np.array([3, -1])])
    with pytest.raises(TypeError, match="1-D"):
        eng.submit_many([np.arange(4).reshape(2, 2)])
    eng.close()


def test_multi_device_round_robin_keeps_cache_coherent():
    # two replicas (two handles to the CPU here): misses round-robin over
    # both; each repeat must hit the shared cache whichever replica
    # scored it first
    eng = _engine(max_batch=4, nnz_buckets=(64,), row_buckets=(1, 2, 4),
                  dedup_cache=True, dedup_entries=32, replicas=2)
    docs = _docs(6, seed=0, lo=20, hi=21)
    for d in docs:
        eng.submit(d).result(timeout=WAIT_S)
    runs = eng.batcher.batches_run
    for d in docs:
        want = float(eng.score_docs([d])[0])
        assert float(eng.submit(d).result(timeout=WAIT_S)) == want
    assert eng.batcher.batches_run == runs
    assert eng.dedup.stats()["hits"] >= len(docs)
    assert min(eng.device_batches) >= 1      # both replicas exercised
    eng.close()


# ---------------------------------------------------------------------------
# /status exposure


def test_status_keys_superset_of_engine_stats():
    eng = _engine(dedup_cache=True, dedup_entries=64)
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    try:
        client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
        client.score([[1, 5, 9]])
        status = client.status()
        missing = set(eng.stats()) - set(status)
        assert not missing, f"/status lost engine keys: {missing}"
        assert status["dedup"]["enabled"] is not False
        for key in ("hits", "misses", "entries", "bytes"):
            assert key in status["dedup"]
        client.close()
    finally:
        srv.request_drain()
        assert srv.wait_finished(timeout=WAIT_S)


# ---------------------------------------------------------------------------
# histogram / stats helpers


def test_suggest_buckets_degenerate_inputs():
    h = NnzHistogram()
    assert h.suggest_buckets() is None                  # no samples
    h.record(10)
    assert h.suggest_buckets(min_samples=2) is None     # below floor
    h2 = NnzHistogram()
    for _ in range(100):
        h2.record(33)                                   # single bin
    got = h2.suggest_buckets(min_samples=64)
    assert got is not None and len(got) == 1 and got[0] >= 33
    h3 = NnzHistogram()
    for n in (4, 64, 1024):
        for _ in range(50):
            h3.record(n)                                # equal masses
    grid = h3.suggest_buckets(max_buckets=3, min_samples=64)
    assert grid is not None and list(grid) == sorted(grid)
    assert grid[-1] >= 1024
    with pytest.raises(ValueError, match="max_buckets"):
        h3.suggest_buckets(max_buckets=0)


def test_nnz_histogram_record_many_matches_record():
    a, b = NnzHistogram(), NnzHistogram()
    sizes = [0, 1, 2, 3, 100, 4096]
    for n in sizes:
        a.record(n)
    b.record_many(sizes)
    assert a.counts() == b.counts()
    b.record_many([])
    assert a.counts() == b.counts()


def test_stats_window_record_batch_matches_record():
    a, b = StatsWindow(size=16), StatsWindow(size=16)
    for _ in range(5):
        a.record(0.002, rows=1, tenant="t")
    b.record_batch(0.002, 5, tenant="t")
    sa, sb = a.snapshot(), b.snapshot()
    assert sa["count"] == sb["count"] == 5
    assert sa["p50_ms"] == pytest.approx(sb["p50_ms"])
    assert sa["per_tenant_rows"] == sb["per_tenant_rows"]
    b.record_batch(0.001, 0)                 # no-op
    assert b.snapshot()["count"] == 5
