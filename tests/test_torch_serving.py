"""Port vs reference: the serving engine as a whole.

The same params, hash seed and documents go through the reference's
``HashedClassifierEngine.score_docs`` and the port's on
``device="cpu"``; scores must be allclose at 1e-5 (not bitwise: the
reference's own fused path differs from its unfused one by ~1e-8, and
the port sums in another order).  Also: futures equal ``score_docs``,
weight-version pinning across ``swap_weights``, the empty-document
rules, replicas, and that ``device=None`` raises without CUDA."""
import threading

import numpy as np
import pytest
import torch

import jax

from repro.models import linear as jlinear
from repro.serving import HashedClassifierEngine as JEngine

from repro_torch.models import linear as tlinear
from repro_torch.serving import (HashedClassifierEngine, VersionedScore,
                                 VersionedVector)

TOL = dict(rtol=1e-5, atol=1e-5)
BUCKETS = dict(nnz_buckets=(64, 256), row_buckets=(4, 16))


def _docs(seed, n, lo=1, hi=200):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, 1 << 33, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _params(k, b, n_classes=2, seed=0):
    cfg = jlinear.BBitLinearConfig(k=k, b=b, n_classes=n_classes)
    p = jlinear.init_bbit_linear(cfg, jax.random.key(seed))
    return {"table": np.asarray(p["table"]),
            "bias": np.full((cfg.n_out,), 0.25, np.float32)}


def _engine(params_np, k, b, scheme, n_classes=2, **kw):
    cfg = tlinear.BBitLinearConfig(k=k, b=b, n_classes=n_classes)
    params = tlinear.params_from_jax(params_np, device="cpu")
    kw = {**dict(seed=7, scheme=scheme, device="cpu", **BUCKETS), **kw}
    return HashedClassifierEngine(params, cfg, **kw)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [4, 8])
def test_scores_match_reference_engine(scheme, b):
    k = 16
    params_np = _params(k, b, seed=b)
    docs = _docs(b, 11)
    ref = JEngine({n: jax.numpy.asarray(v) for n, v in params_np.items()},
                  jlinear.BBitLinearConfig(k=k, b=b), seed=7, scheme=scheme,
                  precompile=False, **BUCKETS)
    want = ref.score_docs(docs)
    ref.close()
    with _engine(params_np, k, b, scheme) as eng:
        got = eng.score_docs(docs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_multiclass_vectors_match_reference_engine():
    k, b = 16, 8
    params_np = _params(k, b, n_classes=4, seed=2)
    docs = _docs(5, 6)
    ref = JEngine({n: jax.numpy.asarray(v) for n, v in params_np.items()},
                  jlinear.BBitLinearConfig(k=k, b=b, n_classes=4), seed=7,
                  scheme="oph", precompile=False, **BUCKETS)
    want = ref.score_docs(docs)
    ref.close()
    with _engine(params_np, k, b, "oph", n_classes=4) as eng:
        got = eng.score_docs(docs)
        futs = eng.submit_many(docs)
        eng.flush()
        vecs = [f.result(timeout=30) for f in futs]
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, want, **TOL)
    assert all(isinstance(v, VersionedVector) and v.version == "v0"
               for v in vecs)
    assert np.array_equal(np.stack(vecs), got)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_futures_equal_score_docs(scheme):
    docs = _docs(3, 25, hi=300)
    with _engine(_params(16, 8), 16, 8, scheme, max_batch=8) as eng:
        want = eng.score_docs(docs)
        futs = [eng.submit(d) for d in docs[:5]] + eng.submit_many(docs[5:])
        eng.flush()
        got = [f.result(timeout=30) for f in futs]
        stats = eng.stats()
    assert all(isinstance(s, VersionedScore) and s.version == "v0"
               for s in got)
    assert np.array_equal(np.asarray(got, np.float32), want)
    assert stats["requests_served"] == 25 and stats["count"] == 25
    plain = ("minhash_pack_plain" if scheme == "minwise"
             else "oph_pack_plain")
    assert stats["kernels"][plain] >= 1


def test_swap_weights_pins_versions():
    docs = _docs(9, 8)
    p0 = _params(16, 4, seed=0)
    p1 = _params(16, 4, seed=1)
    with _engine(p0, 16, 4, "oph") as eng:
        old = eng.current_weights()
        s0 = eng.score_docs(docs)
        assert eng.swap_weights(tlinear.params_from_jax(p1, device="cpu")) \
            == "v1"
        s1 = eng.score_docs(docs)
        assert not np.allclose(s0, s1)
        assert np.array_equal(eng.score_docs(docs, weights=old), s0)
        fut = eng.submit(docs[0])
        eng.flush()
        assert fut.result(timeout=30).version == "v1"
        assert eng.swap_weights(p0, version="canary") == "canary"
        assert np.array_equal(eng.score_docs(docs), s0)
        with pytest.raises(ValueError):
            eng.swap_weights(_params(16, 8))        # another b
        assert eng.version == "canary" and eng.reloads == 2


def test_concurrent_swaps_never_mix_versions():
    docs = _docs(4, 6)
    ps = [_params(16, 4, seed=s) for s in range(3)]
    with _engine(ps[0], 16, 4, "minwise") as eng:
        ref = {}
        for i, p in enumerate(ps):
            eng.swap_weights(p, version=f"w{i}")
            ref[f"w{i}"] = eng.score_docs(docs)
        stop = threading.Event()

        def swapper():
            i = 0
            while not stop.is_set():
                eng.swap_weights(ps[i % 3], version=f"w{i % 3}")
                i += 1

        t = threading.Thread(target=swapper)
        t.start()
        try:
            for _ in range(20):
                futs = eng.submit_many(docs)
                eng.flush()
                res = [f.result(timeout=30) for f in futs]
                for j, s in enumerate(res):
                    assert np.float32(s) == ref[s.version][j]
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()


def test_empty_doc_rules():
    p = _params(16, 8)
    with _engine(p, 16, 8, "oph_zero") as eng:
        scores = eng.score_docs([np.array([], np.int64), np.array([5, 9])])
        assert scores[0] == np.float32(0.25)          # bias only
        fut = eng.submit(np.array([], np.int64))
        eng.flush()
        assert float(fut.result(timeout=30)) == np.float32(0.25)
    for scheme in ("minwise", "oph"):
        with _engine(p, 16, 8, scheme) as eng:
            with pytest.raises(ValueError, match="empty document"):
                eng.submit(np.array([], np.int64))
            with pytest.raises(ValueError, match="empty document"):
                eng.score_docs([[1, 2], np.zeros(0, np.int32)])
            with pytest.raises(ValueError, match="negative"):
                eng.submit_many([[1], [-3]])
            with pytest.raises(TypeError):
                eng.submit([[1, 2]])


def test_replicas_round_robin():
    docs = _docs(6, 5)
    with _engine(_params(16, 4), 16, 4, "oph", replicas=2) as eng:
        a = eng.score_docs(docs, device_index=0)
        b = eng.score_docs(docs, device_index=1)
        futs = eng.submit_many(docs)
        eng.flush()
        [f.result(timeout=30) for f in futs]
        assert np.array_equal(a, b)
        assert eng.stats()["device_batches"][0] >= 1
        assert eng.stats()["device_batches"][1] >= 1


def test_giant_doc_grows_past_the_top_bucket():
    big = np.arange(1000, dtype=np.int64) * 7919
    with _engine(_params(16, 8), 16, 8, "minwise") as eng:
        full = eng.score_docs([big])[0]
        fut = eng.submit(big)
        eng.flush()
        assert fut.result(timeout=30) == full
        assert eng.score_docs([big[:256]])[0] != full


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tlinear.BBitLinearConfig(k=16, b=4)
    params = tlinear.params_from_jax(_params(16, 4), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashedClassifierEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashedClassifierEngine(params, cfg, device="cuda")
