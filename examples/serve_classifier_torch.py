"""Serving demo on the PyTorch port: the hashed classifier behind the
network front end; ``examples/serve_classifier.py`` on ``repro_torch``.

Trains the paper's b-bit hashed linear model, stands up the fused
encode → score engine (``HashedClassifierEngine``: B1 + B5 on the card)
and the stdlib-only HTTP tier on top (``ScoreServer``), then exercises
the service the way an operator would, entirely over HTTP: ``POST
/score`` (every response tagged with its model version), ``POST
/score_ndjson`` (one chunked line a document), ``GET /status``, a 429
with ``Retry-After`` past the in-flight budget, ``POST /reload`` from a
published checkpoint mid-traffic, duplicate traffic through the score
cache (bitwise equal to a fresh dispatch), and a graceful drain.

Engine knobs come from ``configs.rcv1_oph.CONFIG.serve_kwargs()``, the
HTTP knobs from ``CONFIG.http_kwargs()``, both scaled to this demo
corpus.  ``--device cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/serve_classifier_torch.py [--device cuda]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.rcv1_oph import CONFIG
from repro_torch.data import SynthRcv1Config, generate_arrays, preprocess_rows
from repro_torch.devices import resolve_device
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.serving import (HTTPStatusError, HashedClassifierEngine,
                                 ScoreClient, ScoreServer)
from repro_torch.train import train_bbit_liblinear


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--n-docs", type=int, default=700)
    ap.add_argument("--k", type=int, default=64)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=3000, max_triples_per_doc=1500)
    rows, labels = generate_arrays(args.n_docs, cfg)
    k, b = args.k, 8
    scheme = "minwise"
    n_tr = (5 * len(rows)) // 7
    n_te = len(rows) - n_tr
    codes = preprocess_rows(rows, k=k, b=b, seed=1, chunk=256,
                            scheme=scheme, device=dev)
    lcfg = BBitLinearConfig(k=k, b=b)
    res = train_bbit_liblinear(codes[:n_tr], labels[:n_tr], codes[n_tr:],
                               labels[n_tr:], lcfg, loss="logistic",
                               C=1.0, max_iter=25, device=dev)
    print(f"trained model: test acc {res.test_acc:.3f}")

    # paper-scale serve knobs, buckets scaled to this corpus' nnz range
    eng = HashedClassifierEngine(
        res.params, lcfg, seed=1, version="demo-v0", device=dev,
        **CONFIG.serve_kwargs(scheme=scheme, max_wait_ms=3.0,
                              nnz_buckets=(512, 2048, 8192),
                              max_batch=64),
        **CONFIG.dedup_kwargs(dedup_cache=True, dedup_entries=1024))
    print(f"engine up on {dev}: {len(eng.devices)} replica(s), "
          f"{len(eng.nnz_buckets)}x{len(eng.row_buckets)} lanes "
          f"warmed in {eng.precompile_seconds:.2f}s")

    srv = ScoreServer(eng, **CONFIG.http_kwargs(port=0))  # ephemeral port
    srv.start_in_thread()
    print(f"serving on http://{srv.host}:{srv.port}")
    client = ScoreClient(srv.host, srv.port)

    # -- batch scoring over HTTP, 20 docs per request ---------------------
    n_req, per = 10, 20
    t0 = time.perf_counter()
    preds, want = [], []
    for i in range(n_req):
        picks = [n_tr + (i * per + j) % n_te for j in range(per)]
        resp = client.score([rows[p] for p in picks], tenant="demo")
        preds.extend(float(np.ravel(s)[0]) for s in resp["scores"])
        want.extend(labels[p] for p in picks)
    dt = time.perf_counter() - t0
    acc = float(np.mean((np.array(preds) > 0).astype(int)
                        == np.array(want)))
    print(f"scored {n_req * per} docs over {n_req} HTTP requests in "
          f"{dt:.2f}s (version {resp['version']}); accuracy={acc:.3f}")

    # -- streaming endpoint ----------------------------------------------
    lines = client.score_ndjson([rows[n_tr + j] for j in range(8)])
    print(f"ndjson stream: {len(lines)} lines, first="
          f"{{'i': {lines[0]['i']}, 'version': {lines[0]['version']!r}}}")

    # -- live stats -------------------------------------------------------
    st = client.status()
    e = st["engine"]
    print(f"/status: health={st['health']} p50={e['p50_ms']:.1f}ms "
          f"p95={e['p95_ms']:.1f}ms rows/s={e['rows_per_s']:.0f} "
          f"compile_misses={e['compile_misses']} "
          f"tenants={e['per_tenant_rows']}")

    # -- backpressure: one request bigger than the in-flight budget -------
    try:
        client.score([[1, 2, 3]] * (srv.admission.limit + 1))
    except HTTPStatusError as err:
        print(f"oversized request rejected: HTTP {err.status}, "
              f"Retry-After {err.retry_after_s}s")

    # -- versioned hot-reload mid-traffic ---------------------------------
    res2 = train_bbit_liblinear(codes[:n_tr - 100], labels[:n_tr - 100],
                                codes[n_tr:], labels[n_tr:], lcfg,
                                loss="logistic", C=1.0, max_iter=25,
                                device=dev)
    with tempfile.TemporaryDirectory(prefix="serve_demo_ckpt_") as ckpt_dir:
        ckpt.publish_params(ckpt_dir, 1, res2.params)
        info = client.reload(ckpt_dir, version="demo-v1")
    resp = client.score([rows[n_tr]])
    print(f"hot-reloaded to {info['version']} "
          f"(reload #{info['reloads']}); new scores tagged "
          f"{resp['version']!r}")

    # -- duplicate traffic: the viral-document short-circuit --------------
    viral = rows[n_tr + 10]
    fresh = float(np.ravel(client.score([viral])["scores"][0])[0])
    repeats = [float(np.ravel(client.score([viral] * 10)["scores"][j])[0])
               for j in range(10)]
    d = client.status()["dedup"]
    same = all(r == fresh for r in repeats)
    print(f"duplicate traffic: 10 repeats all "
          f"{'bitwise-equal' if same else 'DIVERGED'} to the fresh score; "
          f"cache hits={d['hits']} misses={d['misses']} "
          f"entries={d['entries']} invalidations={d['invalidations']} "
          f"(reload wiped demo-v0)")
    assert same

    # -- graceful drain (the SIGTERM path) --------------------------------
    client.close()
    srv.request_drain()
    assert srv.wait_finished(timeout=30)
    print(f"drained clean={srv.drained_clean}; "
          f"{srv.http_requests} HTTP requests served")
    assert res.test_acc > 0.85 and srv.drained_clean


if __name__ == "__main__":
    main()
