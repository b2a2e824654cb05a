"""Serving launcher of the port.

    python -m repro_torch.launch.serve [--http] [--host H] [--port P] \\
        [--device cuda] [--n-docs 600] [--k 64] [--b 8] [--requests 200] \\
        [--max-batch 64] [--adapt-every N] [--dedup-cache] \\
        [--cache-entries N] [--drain-timeout-s S] [--profile PATH] \
        [--seed 0]

``--mode classifier`` (the default) generates a synthetic expanded-rcv1
corpus, hashes it (``preprocess_rows``, minwise, kernel B3 on the card)
and fits a small hashed classifier with TRON (``train_bbit_liblinear``,
B7/B8), stands up the dynamically batched engine on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions), then
either replays a request stream in-process (throughput and accuracy)
or, with ``--http``, serves it over the network front end
(``serving.ScoreServer``: POST /score, POST /score_ndjson, GET /status,
GET /healthz, POST /reload, graceful drain on SIGTERM) until
terminated.  ``--port 0`` picks an ephemeral port.

Once the socket is bound it prints the machine-readable lines
``DEDUP_CACHE ...`` (``--dedup-cache`` puts the band-keyed
duplicate-traffic score cache in front of the batcher; ``--cache-entries``
caps it) and ``LISTENING <host> <port>``.  ``--profile`` loads a
cost-model profile (default: ``configs/rcv1_oph.py``'s ``profile_path``
if it exists; ``python -m repro_torch.launch.calibrate`` writes one): with
a usable one the engine sizes each lane's row buckets and drain cap from
its measured ``serve_score`` curve; a missing, corrupt or other-box
profile leaves the static pair of row buckets (1, ``--max-batch``).
``--mode lm`` (the LM zoo, ROADMAP A6) is not ported yet and exits 2
with a message.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

NOT_PORTED = {
    "lm": "--mode lm decodes the LM zoo (greedy_generate), which waits "
          "for ROADMAP A6",
}


def _build_classifier_engine(args):
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import preprocess_rows
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    from repro_torch.models.linear import BBitLinearConfig
    from repro_torch.serving import HashedClassifierEngine
    from repro_torch.train.linear_trainer import train_bbit_liblinear

    cfg = SynthRcv1Config(seed=args.seed, topic_tokens=150,
                          background_frac=0.35,
                          max_pairs_per_doc=3000,
                          max_triples_per_doc=1500)
    rows, labels = generate_arrays(args.n_docs, cfg)
    codes = preprocess_rows(rows, args.k, args.b, seed=1, chunk=256,
                            device=args.device)
    n_tr = args.n_docs * 2 // 3
    lcfg = BBitLinearConfig(k=args.k, b=args.b)
    res = train_bbit_liblinear(codes[:n_tr], labels[:n_tr],
                               codes[n_tr:], labels[n_tr:], lcfg,
                               loss="logistic", C=1.0, max_iter=25,
                               device=args.device)
    print(f"model ready: test acc {res.test_acc:.3f} on {args.device}")
    from repro_torch import perf
    profile = args.profile if args.profile is not None \
        else CONFIG.profile_path
    has_profile = perf.maybe_load_profile(profile)
    print("dispatch: "
          + (f"cost-model profile {profile}" if has_profile
             else "static rules (no usable profile)"))
    dedup_kw = {}
    if args.dedup_cache:
        dedup_kw = CONFIG.dedup_kwargs(dedup_cache=True,
                                       dedup_entries=args.cache_entries)
    eng = HashedClassifierEngine(
        res.params, lcfg, seed=1, max_batch=args.max_batch,
        nnz_buckets=(2048, 8192),
        # a measured profile sizes each lane's row buckets and drain cap
        # from its serve_score curve; without one, the static pair
        row_buckets=None if has_profile else (1, args.max_batch),
        adapt_every=args.adapt_every, device=args.device, **dedup_kw)
    if args.dedup_cache:
        print(f"DEDUP_CACHE entries={args.cache_entries} "
              f"rows_per_band={CONFIG.dedup_rows_per_band} "
              f"probe_bands={CONFIG.dedup_probe_bands}", flush=True)
    else:
        print("DEDUP_CACHE off", flush=True)
    return eng, rows, labels, n_tr


def serve_classifier(args) -> None:
    eng, rows, labels, n_tr = _build_classifier_engine(args)
    if args.http:
        from repro_torch.serving import ScoreServer
        srv = ScoreServer(
            eng, host=args.host, port=args.port,
            drain_timeout_s=args.drain_timeout_s,
            on_started=lambda s: (
                print(f"LISTENING {s.host} {s.port}", flush=True)))
        try:
            srv.run()                # blocks until SIGTERM/SIGINT
        finally:
            print(f"drained clean={srv.drained_clean} after "
                  f"{srv.http_requests} requests", flush=True)
        return
    eng.submit(rows[0]).result(timeout=300)   # first-request sanity
    t0 = time.perf_counter()
    futs = [eng.submit(rows[n_tr + i % (args.n_docs - n_tr)])
            for i in range(args.requests)]
    preds = np.array([f.result(timeout=300) for f in futs]) > 0
    dt = time.perf_counter() - t0
    want = np.array([labels[n_tr + i % (args.n_docs - n_tr)]
                     for i in range(args.requests)])
    print(f"{args.requests} requests in {dt:.2f}s "
          f"({args.requests/dt:.0f} req/s, "
          f"{eng.batcher.batches_run} batches), "
          f"accuracy {float(np.mean(preds == want)):.3f}")
    eng.close()


def main(argv=None) -> int:
    from repro_torch.configs.rcv1_oph import CONFIG

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="classifier",
                    choices=["classifier", "lm"])
    ap.add_argument("--n-docs", type=int, default=600)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP instead of replaying a "
                         "request stream in-process")
    ap.add_argument("--host", default=CONFIG.serve_host)
    ap.add_argument("--port", type=int, default=CONFIG.serve_port,
                    help="0 picks an ephemeral port")
    ap.add_argument("--drain-timeout-s", type=float,
                    default=CONFIG.serve_drain_timeout_s)
    ap.add_argument("--adapt-every", type=int, default=0,
                    help="re-derive the nnz lane grid from live traffic "
                         "every N requests (0 = static grid)")
    ap.add_argument("--dedup-cache", action="store_true",
                    help="enable the band-keyed duplicate-traffic score "
                         "cache (serving/dedup.py) in front of the "
                         "batcher")
    ap.add_argument("--cache-entries", type=int,
                    default=CONFIG.dedup_entries,
                    help="dedup cache capacity (LRU entries)")
    ap.add_argument("--profile", default=None,
                    help="cost-model profile JSON (default: the config's "
                         "profile_path if it exists; missing or "
                         "mismatched files leave the static rules)")
    args = ap.parse_args(argv)
    if args.mode != "classifier":
        print(NOT_PORTED[args.mode], file=sys.stderr)
        return 2
    serve_classifier(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
