"""The port's ``DynamicBatcher`` (the cases of ``tests/test_serving.py``)
and the engine's unfused path on the CPU: ``fused=False`` (raw-minima
encode to int32 codes, then the widened product) allclose (1e-5) to
``fused=True`` and to the reference's ``fused=False`` at the same params
and hash seed, for every scheme; its futures equal its ``score_docs``;
and it takes the raw-encode and widened-product operations (here their
plain versions), never the packed ones."""
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from repro.models import linear as jlinear
from repro.serving import HashedClassifierEngine as JEngine

from repro_torch.kernels import ops
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.serving import DynamicBatcher, HashedClassifierEngine

TOL = dict(rtol=1e-5, atol=1e-5)
BUCKETS = dict(nnz_buckets=(64, 256), row_buckets=(4, 16))
WAIT_S = 60


def test_dynamic_batcher_batches_and_resolves():
    calls = []

    def run(xs):
        calls.append(len(xs))
        return [x * 2 for x in xs]

    b = DynamicBatcher(run, max_batch=8, max_wait_ms=20)
    futs = [b.submit(i) for i in range(20)]
    results = [f.result(timeout=5) for f in futs]
    assert results == [2 * i for i in range(20)]
    assert b.requests_served == 20
    assert max(calls) > 1          # batching actually happened
    b.close()


def test_dynamic_batcher_close_flushes_pending_with_racing_submitter():
    """``close()`` flushes (or fails) every accepted future and joins the
    worker; submits that lose the race raise instead of hanging."""
    def slow_run(xs):
        time.sleep(0.005)
        return [x + 1 for x in xs]

    b = DynamicBatcher(slow_run, max_batch=4, max_wait_ms=1)
    accepted, rejected = [], []

    def submitter():
        for i in range(200):
            try:
                accepted.append((i, b.submit(i)))
            except RuntimeError:
                rejected.append(i)
                return
            time.sleep(0.0005)

    t = threading.Thread(target=submitter)
    t.start()
    time.sleep(0.02)               # let a backlog build up
    b.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert rejected or len(accepted) == 200
    # every accepted future is DONE after close() returns — none hang
    for i, f in accepted:
        assert f.done()
        assert f.result(timeout=0) == i + 1
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError):
        b.submit(0)


def test_dynamic_batcher_close_is_idempotent_and_fails_cleanly():
    def boom(xs):
        raise ValueError("kaput")

    b = DynamicBatcher(boom, max_batch=4, max_wait_ms=1)
    fut = b.submit(1)
    b.close()
    b.close()
    with pytest.raises(ValueError, match="kaput"):
        fut.result(timeout=0)


def test_dynamic_batcher_survives_client_cancelled_futures():
    d = DynamicBatcher(lambda xs: [x * 2 for x in xs],
                       max_batch=8, max_wait_ms=20)
    fut = d.submit(1)
    fut.cancel()
    ok = d.submit(2)
    assert ok.result(timeout=10) == 4
    d.close()


# ------------------------------------------------------ fused=False -----

def _docs(seed, n, lo=1, hi=200):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, 1 << 33, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _params(k, b, seed):
    rng = np.random.default_rng(seed)
    return {"table": (0.5 * rng.standard_normal((k, 1 << b, 1))
                      ).astype(np.float32),
            "bias": np.full((1,), 0.25, np.float32)}


def _engine(params_np, k, b, scheme, **kw):
    return HashedClassifierEngine(params_np, BBitLinearConfig(k=k, b=b),
                                  seed=7, scheme=scheme, device="cpu",
                                  **{**BUCKETS, **kw})


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
@pytest.mark.parametrize("b", [4, 8])
def test_unfused_matches_fused_and_reference(scheme, b):
    k = 16
    params_np = _params(k, b, seed=b)
    docs = _docs(b, 21)
    if scheme == "oph_zero":
        docs[4] = np.array([], np.int64)
    with _engine(params_np, k, b, scheme, fused=False, max_batch=8) as eng:
        unfused = eng.score_docs(docs)
        futs = eng.submit_many(docs)
        eng.flush()
        served = np.asarray([f.result(timeout=WAIT_S) for f in futs],
                            np.float32)
    with _engine(params_np, k, b, scheme) as eng:
        fused = eng.score_docs(docs)
    ref = JEngine({n: jnp.asarray(v) for n, v in params_np.items()},
                  jlinear.BBitLinearConfig(k=k, b=b), seed=7, scheme=scheme,
                  fused=False, precompile=False, **BUCKETS)
    want = np.asarray(ref.score_docs(docs))
    ref.close()
    assert unfused.dtype == want.dtype and unfused.shape == want.shape
    assert np.array_equal(served, unfused)
    np.testing.assert_allclose(unfused, fused, **TOL)
    np.testing.assert_allclose(unfused, want, **TOL)


@pytest.mark.parametrize("scheme,encode", [("minwise", "minhash"),
                                           ("oph", "oph"),
                                           ("oph_zero", "oph")])
def test_unfused_takes_the_raw_encode_and_the_widened_product(scheme, encode):
    """On the CPU the unfused path counts the raw-minima encode's and the
    widened product's plain calls (on the card: B3/B4 and B7; oph_zero's
    masked product has no kernel) and none of the packed operations."""
    with _engine(_params(16, 8, seed=1), 16, 8, scheme, fused=False) as eng:
        ops.reset_counts()
        eng.score_docs(_docs(2, 9))
        counts = ops.counts()
    assert counts[f"{encode}_plain"] == 1
    assert counts["bbit_linear_fwd_plain"] == 1
    assert sum(v for name, v in counts.items()
               if name not in (f"{encode}_plain",
                               "bbit_linear_fwd_plain")) == 0
