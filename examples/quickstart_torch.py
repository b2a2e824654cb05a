"""Quickstart on the PyTorch port: the paper's pipeline end to end;
``examples/quickstart.py`` on ``repro_torch``.

  synthetic expanded-rcv1 docs → k×b-bit minwise hashing (one-time; B3
  on the card) → LIBLINEAR-style TRON training (Eq. 9; B7/B8) → test
  accuracy → the same model served with dynamic batching (B1 + B5) →
  the same engine behind the HTTP front end → a measured dispatch
  profile → duplicate traffic through the score cache.

``--device cpu`` runs every kernel's plain version.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
"""
import argparse
import tempfile

import numpy as np

from repro_torch import perf
from repro_torch.data import SynthRcv1Config, generate_arrays, preprocess_rows
from repro_torch.devices import resolve_device
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.serving import HashedClassifierEngine, ScoreClient, ScoreServer
from repro_torch.train import train_bbit_liblinear


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--n-docs", type=int, default=800)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--calibrate-budget-s", type=float, default=15.0)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    print("1) generating synthetic expanded-rcv1 corpus "
          "(unigrams + pairs + 1/30 triples)…")
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=4000, max_triples_per_doc=2000)
    rows, labels = generate_arrays(args.n_docs, cfg)
    nnz = [len(r) for r in rows]
    print(f"   {len(rows)} docs; nnz median={int(np.median(nnz))} "
          f"mean={int(np.mean(nnz))}; D=2^30")

    k, b = args.k, args.b
    print(f"2) one-time preprocessing on {dev}: k={k} min-hashes, lowest "
          f"b={b} bits each → {k * b} bits/doc…")
    codes = preprocess_rows(rows, k=k, b=b, seed=1, chunk=256, device=dev)

    print("3) training logistic regression (TRON, the LIBLINEAR "
          "solver) on the hashed codes…")
    n_tr = len(rows) // 2
    lcfg = BBitLinearConfig(k=k, b=b)
    res = train_bbit_liblinear(codes[:n_tr], labels[:n_tr],
                               codes[n_tr:], labels[n_tr:],
                               lcfg, loss="logistic", C=1.0, max_iter=30,
                               device=dev)
    print(f"   test accuracy = {res.test_acc:.3f} "
          f"({res.n_iter} TRON iterations, {res.train_seconds:.1f}s)")

    print("4) serving the trained model (fused hash → score, batched)…")
    n_req = min(32, len(rows) - n_tr)
    eng = HashedClassifierEngine(res.params, lcfg, seed=1, device=dev,
                                 nnz_buckets=(2048, 8192),
                                 row_buckets=(1, 32))
    futs = [eng.submit(r) for r in rows[n_tr:n_tr + n_req]]
    scores = np.array([f.result(timeout=60) for f in futs])
    acc = float(np.mean((scores > 0).astype(int)
                        == labels[n_tr:n_tr + n_req]))
    print(f"   served {n_req} requests in {eng.batcher.batches_run} "
          f"batch(es); accuracy {acc:.3f}")

    print("5) same engine over HTTP (batch scores + live /status)…")
    srv = ScoreServer(eng, port=0)
    srv.start_in_thread()
    client = ScoreClient(srv.host, srv.port)
    resp = client.score(rows[n_tr:n_tr + 8])
    st = client.status()
    print(f"   POST /score → 8 scores tagged {resp['version']!r}; "
          f"GET /status → health={st['health']} "
          f"p50={st['engine']['p50_ms']:.1f}ms")
    srv.request_drain()               # drains the engine too
    srv.wait_finished(timeout=30)

    print("6) calibrate once, run fast: measuring this box's dispatch "
          "cost table (budget-capped)…")
    table = perf.calibrate(k=k, b_values=(b,), schemes=("minwise",),
                           encode_rows=(32,), encode_widths=(128,),
                           logits_rows=(64,), include_serving=False,
                           trials=2, budget_s=args.calibrate_budget_s,
                           device=dev)
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/profile.json"
        table.save(path)                      # versioned, device-keyed
        perf.maybe_load_profile(path)         # what --profile does
        rep = perf.dispatch_report()
    print(f"   {len(table.entries)} measured entries in "
          f"{table.meta['calibrate_seconds']}s; dispatch now profile-"
          f"driven (table {rep['table_version']!r})")

    print("7) duplicate traffic: the minhash-keyed score cache…")
    dedup_eng = HashedClassifierEngine(res.params, lcfg, seed=1, device=dev,
                                       nnz_buckets=(2048, 8192),
                                       row_buckets=(1, 32),
                                       dedup_cache=True,
                                       dedup_entries=128)
    viral = rows[n_tr]
    fresh = float(dedup_eng.submit(viral).result(timeout=60))
    repeats = [float(f.result(timeout=60))
               for f in dedup_eng.submit_many([viral] * 8)]
    d = dedup_eng.stats()["dedup"]
    dedup_eng.close()
    assert all(r == fresh for r in repeats)
    print(f"   8 repeats of one viral doc → {d['hits']} cache hits, "
          f"every score bitwise-equal to the fresh dispatch")

    assert res.test_acc > 0.85


if __name__ == "__main__":
    main()
