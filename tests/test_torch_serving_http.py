"""The port's HTTP serving tier on the CPU: admission and backpressure,
stats, graceful drain under load, versioned hot reload from published
checkpoints, adaptive buckets and watchdog-backed health (the cases of
``tests/test_serving_http.py``, against the port), and parity with the
reference: ``POST /score`` allclose (1e-5) to the reference engine's
``score_docs`` at the same params and hash seed for every scheme, the
same adaptive lane grid on the same traffic, published snapshots read
across the two packages, and ``launch/serve.py --http`` in a
subprocess.  Every wait on a socket, future or thread has a timeout."""
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ckpt import checkpoint as jckpt
from repro.models import linear as jlinear
from repro.serving import HashedClassifierEngine as JEngine
from repro.serving import reload as jreload

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import serve as launch_serve
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.serving import (AdmissionController, BucketBatcher,
                                 Draining, HashedClassifierEngine,
                                 HTTPStatusError, NnzHistogram, Overloaded,
                                 ScoreClient, ScoreServer, StatsWindow,
                                 VersionedScore, WeightSet,
                                 load_serving_params)

TOL = dict(rtol=1e-5, atol=1e-5)
WAIT_S = 60


def _params(k, b, seed):
    rng = np.random.default_rng(seed)
    return {"table": (0.5 * rng.standard_normal((k, 1 << b, 1))
                      ).astype(np.float32),
            "bias": np.full((1,), 0.125, np.float32)}


def _mk_engine(key=0, version="v0", k=8, b=4, **kw):
    cfg = BBitLinearConfig(k=k, b=b)
    kw.setdefault("scheme", "oph")
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 20.0)
    kw.setdefault("nnz_buckets", (16, 64))
    return HashedClassifierEngine(_params(k, b, key), cfg, seed=3,
                                  version=version, device="cpu", **kw), cfg


# Bitwise notes: each request below holds exactly ``max_batch`` docs of
# one lane, so the lane fills and dispatches as one full batch, the
# shape ``score_docs`` pads the oracle to.

def _docs(n, rng=None, lo=3, hi=14):
    rng = rng or np.random.default_rng(5)
    return [np.sort(rng.choice(50000, size=int(rng.integers(lo, hi)),
                               replace=False)) for _ in range(n)]


def _pinned(eng, params):
    """A WeightSet of ``params`` on every replica of ``eng`` (host
    tensors: the engine's replicas are CPU handles here)."""
    return WeightSet(version="staged", params=tuple(
        {n: torch.from_numpy(v) for n, v in params.items()}
        for _ in eng.devices))


def _drain(srv):
    srv.request_drain()
    assert srv.wait_finished(timeout=WAIT_S)


@pytest.fixture(scope="module")
def served():
    eng, _cfg = _mk_engine()
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    yield eng, srv, client
    client.close()
    _drain(srv)


# ------------------------------------------------------------- stats ----

def test_stats_window_percentiles_match_numpy():
    w = StatsWindow(256)
    rng = np.random.default_rng(0)
    lats = rng.gamma(2.0, 0.01, size=200)
    for x in lats:
        w.record(float(x), rows=2, tenant="t")
    s = w.snapshot()
    assert s["count"] == 200
    for q, key in ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms")):
        assert s[key] == pytest.approx(
            float(np.percentile(lats * 1e3, q)), rel=1e-6)
    assert s["per_tenant_rows"] == {"t": 400}


def test_stats_window_wraps_to_most_recent():
    w = StatsWindow(8)
    for x in [5.0] * 8 + [1.0] * 8:   # old epoch fully overwritten
        w.record(x)
    s = w.snapshot()
    assert s["count"] == 16           # lifetime count
    assert s["window"] == 8
    assert s["p99_ms"] == pytest.approx(1000.0)


def test_nnz_histogram_suggests_tight_buckets():
    h = NnzHistogram()
    rng = np.random.default_rng(1)
    for n in rng.integers(3, 30, size=500):
        h.record(int(n))
    assert h.suggest_buckets(min_samples=1000) is None  # not enough yet
    got = h.suggest_buckets(max_buckets=4, min_samples=64)
    assert got and max(got) <= 32     # pow-2 edges covering nnz<30
    assert list(got) == sorted(got)


# --------------------------------------------------------- admission ----

def test_admission_rejects_fast_and_drains():
    a = AdmissionController(limit=4, retry_after_s=0.2)
    a.acquire(3)
    with pytest.raises(Overloaded) as exc:
        a.acquire(2)                  # 3+2 > 4
    assert exc.value.retry_after_s == pytest.approx(0.2)
    a.acquire(1)                      # exactly at the limit is fine
    a.begin_drain()
    with pytest.raises(Draining):
        a.acquire(1)
    assert not a.wait_idle(timeout=0.05)   # 4 rows still held
    a.release(3)
    a.release(1)
    assert a.wait_idle(timeout=5)
    snap = a.snapshot()
    assert snap == {"inflight": 0, "limit": 4, "draining": True,
                    "admitted": 4, "rejected": 2, "refused_draining": 1}


# -------------------------------------------------------- HTTP basics ----

def test_http_score_bitwise_matches_oracle(served):
    eng, _srv, client = served
    docs = _docs(8)                   # exactly max_batch → one full batch
    resp = client.score(docs, tenant="alpha")
    want = np.asarray(eng.score_docs(docs), np.float64)
    assert resp["version"] == "v0"
    assert np.array_equal(np.asarray(resp["scores"], np.float64).ravel(),
                          want.ravel())


def test_http_ndjson_streams_in_order_with_versions(served):
    eng, _srv, client = served
    docs = _docs(8, rng=np.random.default_rng(9))
    lines = client.score_ndjson(docs)
    assert [ln["i"] for ln in lines] == list(range(8))
    assert all(ln["version"] == "v0" for ln in lines)
    want = np.asarray(eng.score_docs(docs), np.float64)
    got = np.asarray([ln["score"] for ln in lines], np.float64)
    assert np.array_equal(got.ravel(), want.ravel())


def test_http_rejects_malformed_input(served):
    _eng, _srv, client = served
    for bad in ({"docs": []}, {"docs": "nope"}, {"docs": [["a"]]},
                {"docs": [[-3, 4]]}):
        with pytest.raises(HTTPStatusError) as exc:
            client._json_call("POST", "/score", bad)
        assert exc.value.status == 400
    with pytest.raises(HTTPStatusError) as exc:
        client._json_call("GET", "/nope")
    assert exc.value.status == 404
    with pytest.raises(HTTPStatusError) as exc:
        client._json_call("GET", "/score")
    assert exc.value.status == 405


def test_http_429_backpressure_with_retry_after(served):
    _eng, srv, client = served
    with pytest.raises(HTTPStatusError) as exc:
        client.score([[1, 2, 3]] * (srv.admission.limit + 1))
    assert exc.value.status == 429
    assert exc.value.retry_after_s and exc.value.retry_after_s > 0
    assert srv.admission.rejected >= srv.admission.limit + 1


def test_http_status_reflects_traffic(served):
    eng, _srv, client = served
    before = client.status()["engine"]["count"]
    lats = []
    for _ in range(6):
        t0 = time.perf_counter()
        client.score(_docs(4), tenant="beta")
        lats.append(time.perf_counter() - t0)
    st = client.status()
    e = st["engine"]
    assert st["health"] == "ok"
    assert e["count"] == before + 24
    assert e["per_tenant_rows"]["beta"] == 24
    assert 0 < e["p50_ms"] <= e["p95_ms"] <= e["p99_ms"]
    # engine-side latency is submit→resolve; it must sit below the
    # client-observed HTTP round-trip for the same traffic
    assert e["p50_ms"] <= float(np.percentile(np.array(lats) * 1e3, 99))
    assert e["compile_misses"] == 0
    assert e["kernels"]["oph_pack_plain"] > 0       # the CPU's plain path
    assert st["admission"]["inflight"] == 0
    hz = client.healthz()
    assert hz["health"] == "ok"


# ------------------------------------------------------------ reload ----

def test_hot_reload_versions_are_exact_under_traffic():
    eng, cfg = _mk_engine(key=0, version="old")
    new_params = _params(cfg.k, cfg.b, seed=7)
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    docs = _docs(8, rng=np.random.default_rng(3))  # one full batch
    # both single-version oracles from the SAME engine, each pinned to
    # its WeightSet
    want_old = np.asarray(
        eng.score_docs(docs, weights=eng.current_weights()), np.float64)
    want_new = np.asarray(eng.score_docs(docs,
                                         weights=_pinned(eng, new_params)),
                          np.float64)
    assert not np.array_equal(want_old, want_new)

    tmp = tempfile.mkdtemp()
    ckpt.publish_params(tmp, 9, new_params)

    stop = threading.Event()
    failures, seen_versions = [], set()
    saw = {"old": threading.Event(), "ckpt-9": threading.Event()}

    def hammer():
        c = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
        while not stop.is_set():
            r = c.score(docs)
            got = np.asarray(r["scores"], np.float64).ravel()
            seen_versions.add(r["version"])
            if r["version"] == "old":
                want = want_old
            elif r["version"] == "ckpt-9":
                want = want_new
            else:
                failures.append(("unknown-version", r["version"]))
                continue
            if not np.array_equal(got, want.ravel()):
                failures.append((r["version"], got.tolist()))
            saw[r["version"]].set()
        c.close()

    t = threading.Thread(target=hammer)
    t.start()
    ctl = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    assert saw["old"].wait(WAIT_S)   # traffic flows before the swap
    time.sleep(0.1)
    info = ctl.reload(tmp)           # mid-traffic swap
    assert info["version"] == "ckpt-9" and info["previous"] == "old"
    assert saw["ckpt-9"].wait(WAIT_S)
    time.sleep(0.1)
    stop.set()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert not failures, failures[:2]
    assert seen_versions == {"old", "ckpt-9"}   # traffic saw both sides
    ctl.close()
    _drain(srv)


def test_reload_errors_leave_weights_untouched(served):
    eng, _srv, client = served
    before = eng.version
    with pytest.raises(HTTPStatusError) as exc:
        client.reload(tempfile.mkdtemp())         # nothing there
    assert exc.value.status == 404
    tmp = tempfile.mkdtemp()
    ckpt.publish_params(tmp, 1, _params(16, 4, seed=1))   # k mismatch
    with pytest.raises(HTTPStatusError) as exc:
        client.reload(tmp)
    assert exc.value.status == 409
    # a training-state checkpoint with nothing published: 409 with the fix
    state = tempfile.mkdtemp()
    ckpt.save(state, 3, {"params": _params(8, 4, seed=2),
                         "opt": {"m": np.zeros(3), "step": np.int64(3)}})
    with pytest.raises(HTTPStatusError) as exc:
        client.reload(state)
    assert exc.value.status == 409
    assert "not a params-only tree" in exc.value.payload["error"]
    assert eng.version == before


def test_mixed_version_batch_is_repaired_to_one_version():
    """If a reload lands between one request's micro-batches, /score
    re-scores pinned to one WeightSet — the response never mixes."""

    class StubEngine:
        version = "w2"

        def __init__(self):
            self.pinned_calls = []
            self._w = WeightSet(version="w2", params=(None,))

        def submit(self, doc, tenant=None):
            import concurrent.futures
            f = concurrent.futures.Future()
            # deterministically mixed: half old, half new
            v = "w1" if len(self.pinned_calls) == 0 and doc[0] % 2 else "w2"
            f.set_result(VersionedScore(float(doc[0]), v))
            return f

        def current_weights(self):
            return self._w

        def score_docs(self, docs, weights=None):
            self.pinned_calls.append(weights)
            return np.asarray([float(d[0]) * 10 for d in docs],
                              np.float32)

        def stats(self):
            return {"version": self.version, "health": {"state": "ok"}}

        def close(self):
            pass

    eng = StubEngine()
    srv = ScoreServer(eng, port=0,
                      admission=AdmissionController(limit=64))
    srv.start_in_thread(timeout=WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    resp = client.score([[1], [2], [3], [4]])
    assert resp["version"] == "w2"
    assert eng.pinned_calls == [eng._w]     # repair used the pinned set
    assert resp["scores"] == [10.0, 20.0, 30.0, 40.0]
    client.close()
    _drain(srv)


# ------------------------------------------------------------- drain ----

def test_graceful_drain_under_load_drops_nothing():
    eng, _cfg = _mk_engine(max_wait_ms=5.0)
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    results, errors = [], []
    stop, flowing = threading.Event(), threading.Event()

    def hammer(seed):
        c = ScoreClient("127.0.0.1", srv.port, timeout=30)
        docs = _docs(4, rng=np.random.default_rng(seed))
        while not stop.is_set():
            try:
                r = c.score(docs)
                results.append(len(r["scores"]))
                flowing.set()
            except HTTPStatusError as e:
                if e.status == 503:       # refused during drain — fine
                    return
                errors.append(e)
                return
            except OSError:               # socket closed post-drain
                return
        c.close()

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    assert flowing.wait(WAIT_S)
    time.sleep(0.3)                       # real load in flight
    srv.request_drain()
    assert srv.wait_finished(timeout=WAIT_S)
    stop.set()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert not errors, errors[:2]
    assert results                         # traffic actually flowed
    assert all(n == 4 for n in results)    # every 200 was complete
    assert srv.drained_clean is True
    assert srv.admission.snapshot()["inflight"] == 0


# ------------------------------------------------- adaptive buckets ----

def test_adaptive_buckets_converge_on_skewed_workload():
    eng, _cfg = _mk_engine(nnz_buckets=(2048, 8192),
                           max_batch=4)     # grid far too wide
    before = eng.nnz_buckets
    docs = _docs(96, rng=np.random.default_rng(2), lo=3, hi=14)
    for f in [eng.submit(d) for d in docs]:
        f.result(timeout=WAIT_S)
    got = eng.adapt_buckets(max_buckets=3)
    assert eng.rebuckets == 1
    assert got != before and max(got) <= 16   # converged to the traffic
    # post-rebucket traffic scores correctly on the new lanes; groups of
    # exactly max_batch same-lane docs are full batches, bitwise equal
    # to the same-shape score_docs oracle
    misses = eng.compile_misses
    rng = np.random.default_rng(8)
    for _ in range(3):
        group = _docs(4, rng=rng, lo=9, hi=14)   # all route to lane 16
        futs = [eng.submit(d) for d in group]
        got_scores = np.asarray([float(f.result(timeout=WAIT_S))
                                 for f in futs], np.float64)
        want = np.asarray(eng.score_docs(group), np.float64)
        assert np.array_equal(got_scores.ravel(), want.ravel())
    assert eng.compile_misses == misses
    eng.close()


def test_adapt_every_triggers_background_rebucket():
    eng, _cfg = _mk_engine(nnz_buckets=(2048, 8192), max_batch=4,
                           adapt_every=80)
    docs = _docs(200, rng=np.random.default_rng(4), lo=3, hi=14)
    for f in [eng.submit(d) for d in docs]:
        f.result(timeout=WAIT_S)
    deadline = time.time() + 30
    while eng.rebuckets == 0 and time.time() < deadline:
        time.sleep(0.05)
    assert eng.rebuckets >= 1
    assert max(eng.nnz_buckets) <= 16
    assert eng.stats()["rebuckets"] == eng.rebuckets
    eng.close()


# ---------------------------------------------------------- watchdog ----

def test_stalled_resolve_flips_health_degraded():
    gate = threading.Event()

    def dispatch(key, items):
        return items

    def resolve(handle):
        gate.wait(5)                   # a wedged device sync
        return [x * 2 for x in handle]

    b = BucketBatcher(dispatch, resolve, route=lambda x: 1, max_batch=2,
                      max_wait_ms=1.0, stall_after_s=0.05)
    assert b.health()["state"] == "ok"
    fut = b.submit(3)
    deadline = time.time() + 5
    while b.health()["state"] == "ok" and time.time() < deadline:
        time.sleep(0.01)
    h = b.health()
    assert h["state"] == "degraded"
    assert h["stalled_thread"] == "resolve"
    assert h["stalled_s"] >= 0.05
    gate.set()
    assert fut.result(timeout=10) == 6
    deadline = time.time() + 5
    while b.health()["state"] != "ok" and time.time() < deadline:
        time.sleep(0.01)
    assert b.health()["state"] == "ok"
    b.close()


def test_degraded_health_surfaces_in_status_endpoint():
    eng, _cfg = _mk_engine()
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    # wedge the batcher's resolve by monkeypatching the live timestamp
    eng.batcher._resolve_started = time.perf_counter() - 60.0
    eng.batcher.stall_after_s = 1.0
    st = client.status()
    assert st["health"] == "degraded"
    with pytest.raises(HTTPStatusError) as exc:
        client.healthz()
    assert exc.value.status == 503
    eng.batcher._resolve_started = None
    assert client.status()["health"] == "ok"
    client.close()
    _drain(srv)


# ----------------------------------------------- parity with the reference

def _ref_engine(params_np, cfg, scheme, **kw):
    return JEngine({n: jnp.asarray(v) for n, v in params_np.items()},
                   jlinear.BBitLinearConfig(k=cfg.k, b=cfg.b), seed=3,
                   scheme=scheme, precompile=False, **kw)


@pytest.mark.parametrize("scheme", ["minwise", "oph", "oph_zero"])
def test_http_score_matches_reference_engine(scheme):
    """The port's ``POST /score`` against the reference engine's
    ``score_docs`` at the same params and hash seed (allclose 1e-5), and
    bit for bit against the port's own ``score_docs`` pinned to the
    same WeightSet."""
    params_np = _params(16, 8, seed=11)
    eng, cfg = _mk_engine(k=16, b=8, scheme=scheme, max_batch=16,
                          dedup_cache=True)
    eng.swap_weights(params_np, version="p")
    docs = _docs(40, rng=np.random.default_rng(12), lo=1, hi=60)
    if scheme == "oph_zero":
        docs[5] = np.array([], np.int64)     # scored as the bias
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    try:
        w = eng.current_weights()
        got = []
        for lo in range(0, len(docs), 7):     # requests of 1..7 docs
            resp = client.score(docs[lo: lo + 7])
            assert resp["version"] == "p"
            got += resp["scores"]
        again = client.score(docs[:10])["scores"]    # dedup hits
    finally:
        client.close()
        _drain(srv)
    got = np.asarray(got, np.float64)
    pinned = np.asarray(eng.score_docs(docs, weights=w), np.float64)
    assert np.array_equal(got, pinned)
    assert np.array_equal(np.asarray(again, np.float64), pinned[:10])
    assert eng.dedup.stats()["hits"] >= 10
    ref = _ref_engine(params_np, cfg, scheme, nnz_buckets=(16, 64))
    want = np.asarray(ref.score_docs(docs), np.float64)
    ref.close()
    np.testing.assert_allclose(got, want, **TOL)


def test_adapt_buckets_reaches_reference_grid():
    docs = _docs(150, rng=np.random.default_rng(21), lo=2, hi=300)
    eng, cfg = _mk_engine(nnz_buckets=(2048, 8192), max_batch=4)
    ref = _ref_engine(_params(8, 4, seed=0), cfg, "oph",
                      nnz_buckets=(2048, 8192), max_batch=4,
                      max_wait_ms=20.0)
    try:
        for e in (eng, ref):
            for f in [e.submit(d) for d in docs]:
                f.result(timeout=WAIT_S)
        got = eng.adapt_buckets(max_buckets=3)
        want = ref.adapt_buckets(max_buckets=3)
    finally:
        eng.close()
        ref.close()
    assert tuple(got) == tuple(want) and eng.rebuckets == ref.rebuckets == 1


def test_published_snapshots_read_across_packages():
    p_ref = _params(8, 4, seed=31)
    p_port = _params(8, 4, seed=32)
    template = {n: np.zeros_like(v) for n, v in p_ref.items()}
    ref_dir, port_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    jckpt.publish_params(ref_dir, 5,
                         {n: jnp.asarray(v) for n, v in p_ref.items()})
    ckpt.publish_params(port_dir, 6,
                        {n: torch.from_numpy(v) for n, v in p_port.items()})
    got, step = load_serving_params(ref_dir, template)
    assert step == 5
    assert all(np.array_equal(got[n], p_ref[n]) for n in p_ref)
    got, step = jreload.load_serving_params(port_dir, template)
    assert step == 6
    assert all(np.array_equal(np.asarray(got[n]), p_port[n])
               for n in p_port)
    # the reload path end to end: the reference's snapshot is served
    eng, _cfg = _mk_engine()
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread(timeout=WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=WAIT_S)
    try:
        info = client.reload(ref_dir)
        docs = _docs(8, rng=np.random.default_rng(33))
        resp = client.score(docs)
    finally:
        client.close()
        _drain(srv)
    assert info["version"] == resp["version"] == "ckpt-5"
    want = eng.score_docs(docs, weights=_pinned(eng, p_ref))
    assert np.array_equal(np.asarray(resp["scores"], np.float32), want)


def test_config_serving_kwargs_match_reference():
    from repro.configs.rcv1_oph import CONFIG as J_CONFIG
    from repro_torch.configs.rcv1_oph import CONFIG
    for name in ("serve_kwargs", "dedup_kwargs", "http_kwargs"):
        assert getattr(CONFIG, name)() == getattr(J_CONFIG, name)(), name
    assert CONFIG.serve_kwargs(max_batch=8)["max_batch"] == 8


def test_launch_serve_refuses_unported_modes(capsys):
    """``--mode lm`` generates greedy tokens from a reduced LM on the
    CPU (ROADMAP A6b)."""
    assert launch_serve.main(["--mode", "lm", "--device", "cpu",
                              "--max-batch", "2", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "(reduced): generated 8 tokens" in out
    assert len(out.split("sample:")[1].split(",")) == 12


def test_launch_serve_http_binds_answers_and_drains(repo_src):
    """``python -m repro_torch.launch.serve --http --device cpu --port 0``
    prints its machine-readable lines, answers ``/score`` and drains on
    SIGTERM."""
    env = dict(os.environ, PYTHONPATH=repo_src)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--device", "cpu", "--port", "0", "--n-docs", "60", "--k", "16",
         "--dedup-cache", "--cache-entries", "128"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    lines = []
    listening = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("LISTENING"):
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert listening.wait(timeout=240), lines
        _, host, port = next(ln for ln in lines
                             if ln.startswith("LISTENING")).split()
        client = ScoreClient(host, int(port), timeout=WAIT_S)
        resp = client.score(_docs(3))
        status = client.status()
        client.close()
        assert resp["version"] == "v0" and len(resp["scores"]) == 3
        assert np.isfinite(resp["scores"]).all()
        assert status["dedup"]["enabled"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    reader.join(timeout=WAIT_S)
    assert not reader.is_alive()
    assert "DEDUP_CACHE entries=128 rows_per_band=4 probe_bands=4" in lines
    assert any(ln.startswith("drained clean=True") for ln in lines), lines
