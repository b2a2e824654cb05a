"""OPH vs k-permutation minwise on the PyTorch port: same accuracy, about
k× cheaper hashing; ``examples/oph_preprocess.py`` on ``repro_torch``.

The quickstart pipeline twice — with the paper's k-permutation hashing
(B3 on the card) and with one permutation hashing (arXiv:1208.1259,
densified per arXiv:1406.4784; B4) — then the OPH model served by the
scheme-aware engine (B2 + B5), then the fused streaming encode
(``preprocess_and_save``: B2 packs on the device, incremental shards)
and a shard-at-a-time evaluation over ``iter_hashed``.  ``--device cpu``
runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/oph_preprocess_torch.py [--device cuda]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.schemes import make_scheme
from repro_torch.data import (SynthRcv1Config, generate_arrays, iter_hashed,
                              preprocess_and_save, preprocess_rows)
from repro_torch.devices import resolve_device
from repro_torch.models.linear import BBitLinearConfig, bbit_logits
from repro_torch.serving import HashedClassifierEngine
from repro_torch.train import train_bbit_liblinear


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--n-docs", type=int, default=600)
    ap.add_argument("--k", type=int, default=256,
                    help="bins; a power of two (OPH)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=4000, max_triples_per_doc=2000)
    rows, labels = generate_arrays(args.n_docs, cfg)
    total_nnz = int(sum(len(r) for r in rows))
    k, b = args.k, 8         # k=256 is configs/rcv1_oph's
    n_tr = len(rows) // 2
    lcfg = BBitLinearConfig(k=k, b=b)

    print(f"{len(rows)} docs, {total_nnz} nonzeros; k={k}, b={b}; {dev}")
    results = {}
    for scheme in ("minwise", "oph"):
        # time the second pass: the first builds the kernels on a card
        preprocess_rows(rows, k=k, b=b, scheme=scheme, seed=1, chunk=256,
                        device=dev)
        t0 = time.perf_counter()
        codes = preprocess_rows(rows, k=k, b=b, scheme=scheme, seed=1,
                                chunk=256, device=dev)
        dt = time.perf_counter() - t0
        evals = total_nnz * make_scheme(scheme, k, 1).hash_evals_per_nonzero
        res = train_bbit_liblinear(codes[:n_tr], labels[:n_tr],
                                   codes[n_tr:], labels[n_tr:],
                                   lcfg, loss="logistic", C=1.0,
                                   max_iter=30, device=dev)
        results[scheme] = res
        print(f"  {scheme:8s}: hashing {dt:6.2f}s "
              f"({evals / 1e6:7.1f}M hash evals)  "
              f"test_acc={res.test_acc:.3f}")

    print("serving the OPH model (scheme-aware engine)…")
    n_req = min(32, len(rows) - n_tr)
    eng = HashedClassifierEngine(results["oph"].params, lcfg, seed=1,
                                 scheme="oph", device=dev,
                                 nnz_buckets=(2048, 8192),
                                 row_buckets=(1, 32))
    futs = [eng.submit(r) for r in rows[n_tr:n_tr + n_req]]
    scores = np.array([f.result(timeout=60) for f in futs])
    acc = float(np.mean((scores > 0).astype(int)
                        == labels[n_tr:n_tr + n_req]))
    print(f"  served {n_req} requests in {eng.batcher.batches_run} "
          f"batch(es); accuracy {acc:.3f}")
    eng.close()

    print("fused streaming preprocess → packed shards (packed bytes only "
          "leave the device)…")
    with tempfile.TemporaryDirectory() as d:
        stats = preprocess_and_save(d, rows, labels, k=k, b=b,
                                    scheme="oph", seed=1, chunk=256,
                                    n_shards=4, device=dev)
        print(f"  {stats['n']} docs → 4 shards in "
              f"{stats['seconds_hashing']:.2f}s "
              f"({stats['mnnz_per_s']:.1f} Mnnz/s recorded in meta.json)")
        correct = total = 0
        w = results["oph"].params
        # shard-at-a-time evaluation: host memory stays O(one shard)
        with torch.no_grad():
            for shard_codes, shard_labels, _ in iter_hashed(d):
                s = bbit_logits(w, torch.from_numpy(
                    shard_codes.astype(np.int32)).to(dev), lcfg)[:, 0]
                correct += int(np.sum((s.cpu().numpy() > 0).astype(int)
                                      == shard_labels))
                total += len(shard_labels)
        print(f"  shard-streamed eval accuracy {correct / total:.3f} "
              f"({total} docs, no full-matrix load)")

    assert results["oph"].test_acc > 0.85
    assert abs(results["oph"].test_acc - results["minwise"].test_acc) < 0.05


if __name__ == "__main__":
    main()
