"""Train without ever holding the dataset, on the PyTorch port: shards
in, shards through; ``examples/stream_train.py`` on ``repro_torch``.

  1. ``preprocess_and_save`` streams raw documents → packed shards (the
     fused encode, B2 for OPH on the card, O(one shard) memory);
  2. ``fit_streaming`` trains straight off those shards: batches are
     assembled on the host in a producer thread ``prefetch`` steps ahead
     and cross as ceil(k·b/8) packed bytes that stay packed into the
     forward (``bbit_logits_packed``: B5, and B6 for dW), with Polyak
     tail averaging and progressive validation;
  3. prefetch depth is cosmetic: the inline run (``prefetch=0``) gives
     the same bits;
  4. a kill (``stop_after_shards``) and a resume from the shard-boundary
     checkpoint give the uninterrupted run's bits;
  5. a scripted fault plan (``ft.faults``) tears the first checkpoint
     write and kills a mid-shard step; ``run_supervised`` quarantines the
     damaged checkpoint, restores the newest valid one after a capped
     backoff, replays the stream and lands on the same bits.

At no point does the (n, k) training matrix exist in memory.
``--device cpu`` runs the kernels' plain versions.

Run:  PYTHONPATH=src python examples/stream_train_torch.py [--device cuda]
"""
import argparse
import tempfile

import torch

from repro_torch.configs.rcv1_oph import CONFIG
from repro_torch.data import (SynthRcv1Config, generate_arrays,
                              preprocess_and_save, preprocess_rows,
                              shard_row_counts)
from repro_torch.devices import resolve_device
from repro_torch.ft import BackoffPolicy, FaultEvent, FaultPlan, faults
from repro_torch.models.linear import BBitLinearConfig, predict_classes
from repro_torch.train import (RestartPolicy, accuracy, fit_streaming,
                               run_supervised, trees_bitwise_equal)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--n-docs", type=int, default=600)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=4000, max_triples_per_doc=2000)
    rows, labels = generate_arrays(args.n_docs, cfg)
    k, b, n_shards = args.k, 8, 8
    n_tr = (2 * len(rows)) // 3
    lcfg = BBitLinearConfig(k=k, b=b)

    with tempfile.TemporaryDirectory() as work:
        root, ck = work + "/hashed", work + "/ckpt"
        stats = preprocess_and_save(root, rows[:n_tr], labels[:n_tr],
                                    k=k, b=b, scheme=CONFIG.scheme,
                                    seed=1, n_shards=n_shards, chunk=128,
                                    device=dev)
        counts = shard_row_counts(root)
        print(f"{stats['n']} docs → {len(counts)} packed shards "
              f"({min(counts)}–{max(counts)} rows each, "
              f"{stats['mnnz_per_s']:.1f} Mnnz/s) on {dev}")

        # paper-scale knobs from the config, shrunk to this demo corpus:
        # a batch must fit the smallest shard, and the trainer refuses
        # oversized batches up front
        kw = CONFIG.stream_kwargs(epochs=args.epochs,
                                  batch_size=min(32, min(counts)), lr=5e-3,
                                  seed=0, ckpt_every_shards=1, device=dev)
        res = fit_streaming(root, lcfg, **kw)
        inline = fit_streaming(root, lcfg, **dict(kw, prefetch=0))
        same_pf = trees_bitwise_equal(res.params, inline.params)
        print(f"prefetch pipeline vs inline: bit-identical={same_pf}")
        assert same_pf
        codes_te = torch.from_numpy(preprocess_rows(
            rows[n_tr:], k=k, b=b, scheme=CONFIG.scheme, seed=1, chunk=128,
            device=dev).astype("int32")).to(dev)
        with torch.no_grad():
            acc_raw = accuracy(predict_classes(res.params, codes_te, lcfg),
                               labels[n_tr:])
            acc_avg = accuracy(predict_classes(res.avg_params, codes_te,
                                               lcfg), labels[n_tr:])
        print(f"streamed {res.examples_seen} examples in {res.n_steps} "
              f"steps ({res.train_seconds:.2f}s): progressive acc "
              f"{res.progressive_acc:.3f}, test acc {acc_raw:.3f} (raw) / "
              f"{acc_avg:.3f} (averaged)")

        print("kill after 5 shards → resume from the checkpoint…")
        part = fit_streaming(root, lcfg, ckpt_dir=ck, stop_after_shards=5,
                             **kw)
        resumed = fit_streaming(root, lcfg, ckpt_dir=ck, **kw)
        same = trees_bitwise_equal(res.params, resumed.params)
        print(f"  interrupted at shard {part.shards_processed}, resumed "
              f"to step {resumed.n_steps}: bit-identical={same}")
        assert same and not part.completed and resumed.completed
        assert acc_avg > 0.9

        # the first checkpoint write is torn, and once restarted the run
        # dies again mid-shard, three quarters of the way through: the
        # torn checkpoint fails its CRC check and is quarantined, and
        # training replays from the newest valid state to the same bits
        print("surviving a crash: torn checkpoint write + mid-shard kill "
              "under run_supervised…")
        plan = FaultPlan([FaultEvent(site="ckpt_write", times=1),
                          FaultEvent(site="train_step",
                                     step=3 * res.n_steps // 4, times=1)])
        policy = RestartPolicy(max_restarts=3,
                               backoff=BackoffPolicy(base_s=0.05, cap_s=0.5))
        with faults.arm(plan):
            sup = run_supervised(root, lcfg, policy=policy,
                                 ckpt_dir=work + "/ckpt_crash", **kw)
        healed = trees_bitwise_equal(res.params, sup.result.params)
        print(f"  {sup.restarts} restarts "
              f"({[c.error for c in sup.crashes]}), "
              f"recovered bit-identical={healed}")
        assert healed and sup.restarts == 2


if __name__ == "__main__":
    main()
