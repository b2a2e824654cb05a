#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path, of the paper's
experiment (TRON over b-bit codes and VW sketches, at the rcv1_oph width
and at the paper's own k=500, b=16), of its streaming path (packed shard
archives, one-pass SGD with checkpoints and a supervised restart), of
its data-parallel streaming (a folded fit, a gang of worker processes
killed and restarted, an elastic resume, compressed gradients), of
its HTTP serving tier (dedup cache, hot reload from the streaming fit's
published checkpoints, admission, drain), of bfloat16 tables through
B5-B8 (streaming, SGD and serving), of the training launcher's
``--mode linear`` at k=500, b=16, of the cost model's calibration and of
banded-LSH search on one NVIDIA GPU, and of the LM zoo's models
(internlm2-1.8b at full width and depth, dense and with b-bit hashed
embeddings; the ten architectures reduced, against the CPU) and of the
same model through the step builders on a one-rank DeviceMesh.

    python3 chip_smoke.py [--out results.json]

Phases, one line of output each (or more), any failure exits non-zero:

  build    compile src/repro_torch/csrc/*.cu with nvcc for sm_90a, one
           process per source, all at once;
  kernels  each CUDA kernel against its plain torch version on the card,
           at k=256: minhash_pack (B1) and oph_pack (B2) byte for byte
           over b in {1, 2, 4, 8} and ragged nnz up to 8192 (nnz=0 and
           nnz<k included); bbit_linear_packed_fwd (B5) at b=8, C in
           {1, 4}, with and without the empty mask, allclose 1e-5;
           bbit_linear_fwd (B7) and bbit_linear_bwd_dw (B8) at b in
           {1, 2, 4, 8, 12}, bbit_linear_packed_bwd_dw (B6) at b in
           {1, 2, 4, 8} with and without the mask, C in {1, 4}, ragged
           k=37 and n=4099, B7 allclose 1e-5, B6 and B8 within 1e-5 of
           each bin's sum of absolute terms (a bin sums up to 2,000 terms
           at b=1) and the same bytes on two calls; vw_sketch (B9) at
           m in {2, 64, 256, 1024, 16384} (both of its designs), byte for
           byte with values of ones, allclose (1e-5, 1e-4) with random
           values, the same bytes on two calls;
  engine   HashedClassifierEngine at the rcv1_oph width (k=256, b=8, 2
           classes) with seeded random weights, for minwise, oph and
           oph_zero: 384 synthetic expanded-rcv1 documents through
           submit / submit_many with the launch counters set to zero just
           before and read just after; the futures must equal score_docs,
           the plain path on the card (allclose 1e-5) and the host numpy
           encode + numpy scores on a subset; then the engine's documents
           per second over a window of several seconds of submit_many
           passes (median and spread over the passes), and one pass under
           torch.profiler for the device's busy time;
  train    the paper's experiment at the rcv1_oph width (k=256, b=8, 2
           classes, C=1): 20,000 synthetic expanded-rcv1 documents
           (examples/compare_vw_bbit.py's corpus settings, seed 11), the
           first 16,000 to train; preprocess_rows for minwise and oph
           (the raw-minima encode, minhash (B3) and oph (B4), which are
           then held to their plain versions byte for byte on the
           widest full 1,024-row chunk of the corpus),
           train_bbit_liblinear with logistic and squared-hinge loss (30
           TRON iterations at most), VW sketches through ops.vw_sketch at
           equal storage (m=64) and at m=2^14, train_vw_liblinear; the
           launch counters set to zero before and read after; test
           accuracy, iterations, objective and seconds of each run; B8's
           plans built, one per b-bit fit (its training codes); each b-bit
           fit again through the kernels' plain versions on the card,
           which it must match in TRON iterations and objective (1e-3
           relative).  The sketches of both m byte for byte against
           core.vw's.  Then B7,
           B8 and B6 against their plain versions at this phase's own
           shapes: its codes (16,000 and 4,000 rows), trained tables and
           the objective's logistic dout, B6 at 1,024 and 16,000 packed
           rows; B9 on one real 256-document chunk at m=64 and m=2^14.
           Then one gradient of the mean logistic loss over
           bbit_logits_packed on 1,024 packed training rows, for oph and
           for oph_zero with its empty mask (B5 + B6, and B6 alone against
           its plain version), against the gradient through widened
           codes;
  stream   the paper's streaming path at configs/rcv1_oph.py's streaming
           settings on the train phase's first 16,000 documents, cut to
           8 shards of 2,000 rows (the config's 16 would hold fewer rows
           than a batch of 1,024): preprocess_and_save writes oph and
           oph_zero (B2) and minwise (B1) archives under build/, each
           equal to preprocess_rows (B3/B4) byte for byte and passing
           verify_shard; fit_streaming (B5 forward, B6 dW; AdamW, Polyak
           tail averaging, prefetch 2, checkpoints every 4 shards) fits
           the oph archive uninterrupted (its steps timed on the host by
           a StepWatchdog), under run_supervised through a crash injected
           at step 9 (exactly one restart), inline (prefetch 0) and under
           torch.profiler (the device's busy share and the host's top
           ops), all bitwise equal, and the oph_zero archive (B5/B6 with
           the mask; progressive accuracy above 0.5); the held-out 4,000
           rows scored through B2 + B5 above 0.9; train_bbit_sgd (B7, B8
           with a plan a minibatch, counted, not held to one plan); the
           launch counters set to zero before and read after all of it.
           Then, in turns, the encode with one and two chunks in flight
           and the fit at prefetch 0 and 2, each with and without
           checkpoints; the same fit on the CPU: the same steps and rows,
           params allclose (1e-4, 1e-5), progressive accuracy within
           1e-3; and where the two part: both fits replayed step by step
           (ending on each fit's bits), with the gap after each step, B6
           and the card's gradient against the plain versions at the same
           params, and at the element of the largest gap its gradient,
           the rows that hit it, how far their douts cancel and AdamW's
           ratio;
  dp       the data-parallel path on the stream phase's oph archive at
           configs/rcv1_oph.py's streaming settings with data_parallel=2
           (8 steps of two 1,024-row slots), launch counters at zero
           before and read after: fit_streaming folding both slots on the
           card (host ms a step); a 2-rank gang of worker processes
           (run_multiprocess_supervised, both ranks on cuda:0 over gloo)
           with rank 1 killed (SIGKILL) before step 5: exactly one gang
           restart, both ranks' params bitwise equal to the fold; a gang
           stopped after 4 shards, resumed in one process (elastic 2 -> 1)
           bitwise equal to the fold; grad_compress 8 and 1, and AdamW
           with bfloat16 and int8 moments in the serial arm; the fold
           through a one-rank NCCL group (two all-reduces a step) bitwise
           equal to the fold; held-out accuracy above 0.9 for every run
           (B2 + B5); B2, B5 and B6 launched, no plain call (the gang's
           workers count their own, and show B5 and B6 with no plain
           call).  The wire bytes a step of the exact, int8 and sign
           exchanges from the collectives record.  Then the compressed
           and narrow-moment fits on the CPU, allclose (1e-4, 1e-5) to
           the card's; a fit that rounds its state (int8 gradient
           payloads, bfloat16 moments) and misses is replayed on the CPU
           with the card's rounding where the two sides' inputs straddle
           a boundary (each flip checked: inputs within 1e-5 of the
           largest magnitude the rounding sees, int8 results one quantum
           apart) and must then be allclose;
  serve    configs/rcv1_oph.py's serving deployment (serve_kwargs +
           dedup_kwargs: oph, k=256, b=8, nnz lanes 128..32768, row
           buckets 1..64, 2 ms, pipeline depth 2, a dedup cache of 65,536
           entries on 4 probe bands of 4 codes) behind a ScoreServer on an
           ephemeral port, its weights the stream fit's params published
           under its checkpoint directory (load_serving_params, shard 4's
           snapshot first).  First, the dedup keys' host-encode bytes
           against B2 over the 4,000 held-out documents, and one document
           at row buckets 1 and 64 (B5's bits).  Then, with the launch
           counters at zero: POST /score from 4 client threads in requests
           of 1-64 held-out documents, 30 % of the documents sent repeats
           (requests/s, documents/s, client and engine p50/p95/p99, dedup
           hit rate); the same pass again under torch.profiler after
           emptying the cache (the device's busy share); a full batch of
           cached documents through submit_many (dedup hits); POST
           /score_ndjson; a pass during which POST /reload lands to shard
           8's snapshot; reloads from an empty directory (404) and from
           the fit's training state (409); the held-out documents in
           requests of 64 at the new version; one request past
           AdmissionController.for_engine's budget (429 with
           Retry-After); request_drain under load from 4 threads.  Every
           answer equals score_docs pinned to its version's WeightSet bit
           for bit and the host numpy reference allclose 1e-5; dedup hits
           equal fresh scores at row buckets 64 and 1; the served held-out
           accuracy equals the stream phase's within 1e-3; B2 and B5
           launched, no plain call.  Then fused=False for minwise and oph
           (B3/B4 + B7, no plain call) and oph_zero (B4, and the masked
           product's plain version, which has no kernel in either
           package), allclose 1e-5 to the fused path; and adapt_every=256
           on a skewed stream (documents cut to 8-47 ids): at least one
           re-bucket, every score equal to score_docs;
  paper    the same corpus at configs/rcv1_bbit.py's width: preprocess_rows
           at k=500, b=16 (B3), TRON logistic and squared hinge over a
           (500, 65536, 1) table (B7, and B8 from a plan of two radix
           passes); k=30, b=12 (the abstract's 30 hashes, B3, then B7/B8
           at V=4096); oph_zero at k=256, b=8 (B4), its codes against the
           host numpy encode; no plain call at all; one B8 plan per fit;
           the three fits again through the plain versions on the card
           (the same TRON iterations, objectives within 1e-3 relative);
           B7 and B8 against their plain versions on the k=500 codes, the
           logistic fit's (500, 65536, 1) table and its dout, B8's bytes
           equal from a fresh, a cached and a rebuilt plan; the first
           1,024-row chunk's k=500 codes against B3's plain version; the
           reference tests' accuracy limits;
  bf16     bfloat16 tables (BBitLinearConfig.param_dtype): B5 on the
           engine's 64 held-out documents (B2, k=256, b=8) and B7 on the
           paper phase's 16,000 x 500 codes (V=65536, its logistic table
           rounded) bitwise equal to the same kernel on the table widened
           and allclose 1e-5 to their plain versions; B6 on 1,024 training
           rows and B8 (V=65536, a cached plan) bitwise the float32 dW
           rounded to bfloat16, the float32 dW within 1e-5 of each bin's
           sum of absolute terms of the plain version's; each bfloat16
           instantiation timed beside the float32 one on the same inputs.
           Then, with the launch counters at zero: fit_streaming on the
           stream phase's oph archive (configs/rcv1_oph.py's streaming
           settings, a bfloat16 table: B5, B6), stopped after 4 shards and
           resumed (bitwise), and the same fit folding 2 logical slots a
           step (data_parallel=2, elastic); held-out accuracy of its Polyak mean above
           0.9 (B2, B5); train_bbit_sgd (AdamW) at k=500, b=16 on the paper
           codes, 100 steps of 128 rows (B7, B8 on a 65.5 MB table), test
           accuracy above 0.9; an engine (oph, k=256, b=8) serving the
           fit's bfloat16 params and one serving them widened, their
           scores of the 4,000 held-out documents bitwise equal; the four
           bfloat16 instantiations launched, no plain call.  Then both
           fits on the CPU, each allclose (1e-4, 1e-5), or else replayed
           with the card's roundings (B6's dW, AdamW's store of the param)
           where the two sides straddle a bfloat16 boundary, each flip
           checked as in the dp phase, and then allclose;
  linear   launch/train.py --mode linear in process at
           configs/rcv1_bbit.py's k=500, b=16 on the train corpus: the
           4-shard archive preprocess_and_save writes (B1 at b=16, one
           launch a 1,024-document chunk), then 100 AdamW steps of 128
           rows over bbit_logits (B7 and B8 every step) and the test
           forward, with the launch counters set to zero before and read
           after (no plain call); test accuracy above 0.9; the archive
           passes launch/fsck.py, and its first 256 documents' archive is
           byte-equal card vs CPU; a --fail-at 60 run and its rerun
           resume from step 50 and end on the uninterrupted run's bits;
           the first 10 steps again on the CPU, params and losses
           allclose (1e-4, 1e-5).  Then B1 at b in {3, 6, 12, 16}
           (codes that straddle bytes) beside b=8, held to its plain
           version byte for byte and timed, at 64 rows x 8,192 ids
           (k=256) and on the corpus's first 1,024 documents (k=500);
  calibrate launch/calibrate.py (configs/rcv1_oph.py's defaults: oph,
           k=256, b=8, lanes 128/512/2,048, rows 1-64) under a 20 s
           budget: only kernel arms timed, the profile's fingerprint the
           card's; then the profile loaded and an engine built from it
           (its row buckets and lane caps from the serve_score curve)
           scoring 2,000 held-out documents against an engine on the
           static grid: bitwise equal (else allclose 1e-6, and the line
           says which), profile hits in stats()["dispatch"], no plain
           call; one serve pass on each grid, an observation held to no
           limit;
  search   the corpus packed at k=256, b=8 (B2) into a BandedLSHIndex
           with 4 codes per band; 128 exact copies of indexed documents
           (rank 1, similarity 1.0) and 128 near-duplicates with 10 % of
           their ids dropped (in the top 10), ranked by
           hamming_distance (B10); recall@10 against a full scan of the
           20,000 rows; on every 8th query the full scan's distances and
           top-10 indices are held to B10's plain version (and, once, to
           a second call);
  timing   the launch floor (torch.cuda._sleep(0), a kernel that does no
           work, over 500 calls), then each kernel at its main path's
           shapes with CUDA events, its
           plain version, its one-call PyTorch yardstick where there is
           one, and the bound (the larger of bytes over 3.35 TB/s and
           operations over the card's rate for their type: int32 for
           B1-B4, B9 and B10, float32 for B5-B8): B1, B2, B5 at the
           engine's shapes (64 rows x 2048 / 8192 lanes of real documents,
           B5 vs embedding_bag), and at its one-row
           bucket; B7 and B8 at 16,000 x 256 codes, V=256,
           C=1 (vs embedding_bag and bincount), and at the paper fits'
           16,000 x 500 codes, V=65536, B8 over its cached plan and,
           as plan_ms, the plan kernel that builds it; B6 at 1,024 and 16,000
           packed rows (vs bincount on unpacked codes), and at 1,024 rows
           of the oph_zero encode with its empty mask; B9 at m=64 and
           m=2^14 on the middle 256-row chunk of the length-sorted corpus
           and on the widest full one; B3 (k=500 and 256)
           and B4 (k=256) on the widest full 1,024-row chunk of the train
           corpus; B10 over the 20,000 indexed rows and over a typical
           candidate set.
  b7_slices B7 at the TRON benchmark cell's training shape: 541,919 rows of
           uniform random codes at k=500 (a few outside [0, V)) into a
           (500, 65536, 1) table, float32 and bfloat16: one call through
           bbit_linear_fwd must take the bin-slice schedule
           (bbit_linear_fwd_sliced up by one), be the one pass's bits
           and lie within 1e-5 of each row's sum of absolute terms of
           the plain version (taken in 65,536-row chunks); its time,
           the one pass's and the bound join the B7 lines as "sliced".

  lm       the LM zoo (ROADMAP A6a, no B-kernel and no plain version:
           the launch counters stay at 0): internlm2-1.8b as registered
           (24 layers, d_model 2048, 16 heads / 8 KV heads, d_ff 8192,
           vocab 92544, bfloat16; 1.89 B params) from a seeded generator
           on the card, with the dense embedding and then with
           embedding="bbit_hash" (k=8 tables of 4,096 rows): the loss of a
           2 x 512 lm_example_stream batch (finite, within 1 of
           ln(vocab)), prefill of the 2 x 512 prompt (timed), decode held
           to a fresh prefill over the prompt and the tokens so far at the
           first 4 generated positions (16 bfloat16 ulps of the largest
           logit), 31 decode steps timed, one prefill and 4 decode steps
           under torch.profiler (device ms; the busy share is the
           profiled device ms a step over the unprofiled step's ms),
           greedy_generate of 32 tokens equal to the checked loop's, peak
           memory, and the decode step's bound (the bytes it must move
           over 3.35 TB/s: the params but the embedding, the tokens'
           embedding rows, the KV cache's valid positions, the logits).
           Then each of the ten architectures at reduced_config (float32,
           no TF32), the card against the port on the CPU on the same
           params: the loss
           (1e-5 relative), prefill's logits and cache and one decode step
           (1e-4), greedy_generate of 8 tokens (equal, or parted where the
           CPU's top-2 margin is within 2e-4); and
           build_microbatched_train_step, 3 AdamW steps (eps 1e-4) at
           n_micro=2 on reduced internlm2, card against CPU within 1e-5.
  lm_mesh  the LM zoo through launch/steps.py's builders on a one-rank
           NCCL DeviceMesh (data=1, model=1) on cuda:0 (ROADMAP A6b,
           A6c): the lm phase's internlm2-1.8b params and prompt,
           build_prefill_step (logits within the lm phase's bound of the
           mesh-free prefill) and 32 greedy steps of build_decode_step
           (tokens equal to greedy_generate's, or parted only at a tie
           within that bound), each timed beside the mesh-free model
           (wall ms; decode device ms under torch.profiler);
           build_lm_train_step at full width on 4 x 512 with n_micro 2,
           two AdamW steps, after each its params and first moments
           against build_microbatched_train_step's on the mesh-free model
           trained through the same vocab-parallel cross-entropy (1e-5),
           its losses against the plain mesh-free step's (1e-5, then 1e-3
           after a bfloat16 update), and the two cross-entropies'
           gradients on the same logits beside the mean gradients they
           give (where the plain step's gap comes from);
           build_linear_train_step at
           k=500, b=16 on 65,536 rows, three steps against the mesh-free
           AdamW over B7/B8 (1e-5); the dry-run's argument bytes (from a
           CPU subprocess on meta shards) equal to the bytes allocated,
           its peak beside max_memory_allocated; launch/train.py and
           launch/serve.py --mode lm as subprocesses (exit 0, the loss
           falling).

The phases run in the order engine, train, stream, dp, serve, paper,
bf16, linear, calibrate, search, timing, lm, lm_mesh.  The last three lines are the card's
name and power limit, one JSON
object describing every kernel, and {"ok": true, "device": {...}}.  A
kernel's max_abs_err there is its largest error at the main path's
shapes (B1, B2 and B5 in the kernels phase at the engine's rows and
lanes, B3, B4 and B6-B9 in the train and paper phases, B10 in the
search phase, the bfloat16 instantiations in the bf16 phase); the errors
of the edge-case checks of B6-B9 (ragged k and n, b=1..12, C=4) go to
--out only.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

K, B, N_CLASSES = 256, 8, 2          # configs/rcv1_oph.py
ROWS = 64                            # serve_max_batch
NNZ_BUCKETS = (2048, 8192)           # launch/serve.py's lanes
DOCS = 384                           # synthetic documents per scheme
RATE_WINDOW_S = 3.0                  # docs/s: passes over at least this
TOL = dict(rtol=1e-5, atol=1e-5)
# the sleep kernel that the timed calls queue behind, in clock cycles (about
# 0.1 s): it must outlast the host's enqueue of all of them, or the card
# waits for the host and the time is the host's (50M cycles did not cover
# 500 calls of B5's wrapper on a slow host: 10.9 us a call, not 2.9)
TIMING_SLEEP_CYCLES = 200_000_000
# H100 SXM data-sheet peaks: HBM3 bytes/s, and float32 outside the
# tensor cores (B5's adds)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# 32-bit integer operations per SM per clock, at most: each of a Hopper
# SM's four partitions issues one warp instruction (32 lanes) per clock.
# The integer ALU pipe has 16 lanes a partition (64 per SM per clock, the
# NVIDIA H100 Tensor Core GPU Architecture white paper's int32 figure),
# but integer multiplies and multiply-adds issue to the FMA pipe beside
# it, so a mix of the two -- the hashes here -- can exceed 64: B3 ran at
# 1.22x the 64-lane rate on the H100.  The data sheet has no int32 entry,
# so the rate is the issue limit times the card's SM count and its
# maximum SM clock, both read from the card
INT32_OPS_PER_SM_CLOCK = 128
# 32-bit operations per hash: a*t+b, fmix32's 3 shift-xors and 2
# multiplies, then the min (B1, B3) or the bin shift + atomicMin (B2, B4)
OPS_PER_MINHASH = 1 + 8 + 1
OPS_PER_OPH_HASH = 1 + 8 + 2
# two fmix32 (8 each), the multiply-add and xor before them, the mask
# and the bucket-range test (B9)
OPS_PER_VW_ID = 8 + 8 + 2 + 2
# the train phase (configs/rcv1_oph.py, examples/compare_vw_bbit.py)
TRAIN_DOCS, TRAIN_ROWS, TRAIN_SEED = 20_000, 16_000, 11
TRAIN_ITERS, TRAIN_C = 30, 1.0
HASH_SEED, VW_SEED = 1, 2
VW_EQUAL = K * B // 32               # 2048 bits = 64 float32 buckets
VW_WIDE = 1 << 14
VW_CHUNK = 256
STREAM_BATCH = 1024                  # configs/rcv1_oph.py stream_batch
# the stream phase: 16,000 training rows in 8 shards of 2,000 (the
# config's 16 shards would hold 1,000 rows, fewer than a batch), two steps
# a shard, and the supervised fit's crash on the second step of shard 5,
# after the checkpoint at shard 4
STREAM_SHARDS, STREAM_STEPS, STREAM_CRASH_STEP = 8, 16, 9
STREAM_CPU_TOL = dict(rtol=1e-4, atol=1e-5)
PREPROCESS_CHUNK = 1024              # preprocess_rows' chunk
PAPER_K, PAPER_B = 500, 16           # configs/rcv1_bbit.py
# B7's slice schedule: the TRON benchmark cell's training rows (n >= 1.75V),
# checked against the plain version this many rows at a time
SLICED_ROWS, SLICED_CHUNK = 541_919, 1 << 16
# the serve phase: configs/rcv1_oph.py's serving deployment over HTTP on
# the stream fit's published params; 4 client threads, requests of 1-64
# held-out documents, 30 % of the documents sent repeats
SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_serve")
SERVE_CLIENTS, SERVE_MAX_REQUEST, SERVE_REPEAT_FRAC = 4, 64, 0.3
SERVE_WAIT_S = 120
SERVE_UNFUSED_DOCS = 256             # fused=False: held-out docs a scheme
# adapt_every: a skewed stream (held-out documents cut to 8-47 ids) of
# 2 x 1,024 documents, the grid re-derived every 256 submits
ADAPT_EVERY, ADAPT_DOCS = 256, 1024
SERVE_ACC_TOL = 1e-3
ABSTRACT_K, ABSTRACT_B = 30, 12      # examples/compare_vw_bbit.py:26
# the search phase: configs/rcv1_oph.py's retrieval geometry, and
# benchmarks/retrieval_bench.py's near-duplicate churn
ROWS_PER_BAND, TOP_K = 4, 10
SEARCH_QUERIES = 128                 # exact copies, and as many near-dups
SEARCH_CHECK_EVERY = 8               # B10 vs plain on every 8th query
DROP_FRAC = 0.1
# 32-bit operations per word of B10: the XOR, the popcount, the add
OPS_PER_HAMMING_WORD = 3
# the linear phase: launch/train.py --mode linear at configs/rcv1_bbit.py's
# k=500, b=16 on the train corpus (hashed with seed 0, the launcher's):
# 100 AdamW steps of 128 rows, checkpoints every 25, a crash at step 60
# resumed from 50; the first 10 steps again on the CPU; the archive's
# bytes against the CPU's on the first 256 documents
LINEAR_STEPS, LINEAR_BATCH, LINEAR_CKPT_EVERY = 100, 128, 25
LINEAR_SEED, LINEAR_FAIL_AT = 0, 60
LINEAR_CPU_STEPS, LINEAR_CPU_DOCS = 10, 256
# the calibrate phase: launch/calibrate.py's defaults (configs/rcv1_oph.py)
# under a budget of 20 s; the engine built from the profile scores 2,000
# held-out documents
CALIBRATE_BUDGET_S, CALIBRATE_DOCS = 20.0, 2000
GRAD_TOL = dict(rtol=1e-5, atol=1e-8)
# B6/B8 against their plain versions: |err| <= 1e-5 x the sum of the
# absolute terms of each bin (+1e-6), the bound of a reordered float32 sum
DW_SUM_TOL = 1e-5
# a TRON fit through the kernels against the same fit through their plain
# versions: the kernels reorder float32 sums, and TRON stops anywhere its
# gradient falls below 1e-4 of its first (optim/tron.py grad_tol), which
# leaves two paths' objectives apart by far more than their rounding
# (8.9e-5 relative for a squared-hinge fit at k=256 on the H100)
FIT_OBJECTIVE_RTOL = 1e-3
# the lm phase (ROADMAP A6a): internlm2-1.8b as registered (24 layers,
# d_model 2048, bfloat16), a 2 x 512 prompt and 32 greedy tokens, decode
# held to a fresh prefill at the first 4 generated positions; the ten
# architectures at reduced_config (float32, sequences of 16, 8 greedy
# tokens) and the microbatched step (3 AdamW steps, n_micro 2, batches of
# 4), card against CPU at the CPU tests' tolerances
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_SELF_CHECKS = 2, 512, 32, 4
LM_PROFILE_STEPS = 4
LM_REDUCED_SEQ, LM_REDUCED_NEW = 16, 8
LM_MICRO_STEPS, LM_MICRO = 3, 2
LM_LOSS_RTOL, LM_LOGIT_ATOL, LM_MICRO_ATOL = 1e-5, 1e-4, 1e-5
# decode against a fresh prefill, both bfloat16: the two round their
# activations to bfloat16 after matmuls of other shapes, so elements part
# by an ulp (2^-8 relative) and the gap grows through 24 layers; the
# bound is 16 ulps of the largest |logit| (2^-4 of it)
LM_BF16_SELF_TOL = 16 * 2.0 ** -8
# the lm_mesh phase (ROADMAP A6b, A6c): the lm phase's model, params and
# prompt through launch/steps.py's builders on a one-rank NCCL DeviceMesh
# (data=1, model=1); the train step at full width on 4 x 512 with
# n_micro 2 (2 AdamW steps; against the plain mesh-free step the
# cross-entropies' float32 roundings flip bfloat16 roundings in the
# backward, so the second loss is held to 1e-3); the
# paper's linear step at k=500, b=16 on 65,536 rows (3 AdamW steps); the
# launchers' --mode lm in subprocesses
LM_MESH_TRAIN_BATCH, LM_MESH_MICRO, LM_MESH_TRAIN_STEPS = 4, 2, 2
LM_MESH_STEP2_RTOL = 1e-3
# the train step against the mesh-free model trained through the same
# vocab-parallel cross-entropy (_train_state_gap): after each step every
# param within LM_MESH_TRAIN_ATOL, every first moment within it of its
# leaf's largest, the losses within LM_LOSS_RTOL (a one-rank mesh runs
# the same local ops: bitwise equal on the H100)
LM_MESH_TRAIN_ATOL = 1e-5
LM_MESH_LINEAR_STEPS = 3
KERNELS = {
    "minhash_pack": ("src/repro_torch/csrc/fused_encode.cu",
                     "src/repro/kernels/fused_encode.py:128"),
    "oph_pack": ("src/repro_torch/csrc/fused_encode.cu",
                 "src/repro/kernels/fused_encode.py:271"),
    "minhash": ("src/repro_torch/csrc/minhash.cu",
                "src/repro/kernels/minhash.py:73"),
    "oph": ("src/repro_torch/csrc/oph.cu", "src/repro/kernels/oph.py:82"),
    "bbit_linear_packed_fwd": ("src/repro_torch/csrc/bbit_linear.cu",
                               "src/repro/kernels/bbit_linear.py:277"),
    "bbit_linear_packed_bwd_dw": ("src/repro_torch/csrc/bbit_linear.cu",
                                  "src/repro/kernels/bbit_linear.py:363"),
    "bbit_linear_fwd": ("src/repro_torch/csrc/bbit_linear.cu",
                        "src/repro/kernels/bbit_linear.py:80"),
    "bbit_linear_bwd_dw": ("src/repro_torch/csrc/bbit_linear.cu",
                           "src/repro/kernels/bbit_linear.py:147"),
    "vw_sketch": ("src/repro_torch/csrc/vw_sketch.cu",
                  "src/repro/kernels/vw_sketch.py:69"),
    "hamming_distance": ("src/repro_torch/csrc/hamming.cu",
                         "src/repro/kernels/hamming.py:44"),
}
# B5-B8 on a bfloat16 table (BBitLinearConfig.param_dtype), counted apart
KERNELS_BF16 = ("bbit_linear_packed_fwd_bf16",
                "bbit_linear_packed_bwd_dw_bf16", "bbit_linear_fwd_bf16",
                "bbit_linear_bwd_dw_bf16")


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return nvidia_smi("name,power.limit")


def int32_ops_per_s(torch) -> float:
    """Peak 32-bit integer operations per second of card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    rate = sms * INT32_OPS_PER_SM_CLOCK * mhz * 1e6
    print(f"int32 peak: {sms} SMs x {INT32_OPS_PER_SM_CLOCK}/clock x "
          f"{mhz} MHz = {rate:.4g} ops/s")
    return rate


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Device time per call: the calls are queued behind a sleep kernel,
    so the card runs them back to back whatever the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(TIMING_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def int_err(torch, got, want) -> int:
    """Largest absolute difference of two integer tensors (0: equal)."""
    if got.shape != want.shape:
        fail(f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def bound(bytes_: float, ops: float, ops_per_s: float):
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    took = _build.build()
    print(f"build: {json.dumps({n: round(s, 2) for n, s in took.items()})}"
          f" in {time.perf_counter() - t0:.2f} s")
    for name in _build.SIGNATURES:
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "Compiling entry" in line:
                print(f"build: {name}: {line.strip()}")


def phase_kernels(torch, dev):
    """→ (errors at the main path's shapes: B1, B2, B5 at the engine's
    rows and lanes; errors of the edge-case checks of B6-B9)."""
    from repro_torch.core.bbit import pack_codes
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe

    rng = np.random.default_rng(0)
    m = NNZ_BUCKETS[-1]
    idx = torch.from_numpy(
        rng.integers(0, 1 << 31, size=(ROWS, m)).astype(np.int32)).to(dev)
    nnz_np = rng.integers(1, m + 1, size=ROWS).astype(np.int32)
    nnz_np[:4] = [0, 3, K - 1, m]
    nnz = torch.from_numpy(nnz_np).to(dev)
    errs = {}
    a, b = MultiplyShiftHash.make(K, 1).params(dev)
    for bits in (1, 2, 4, 8):
        got = fe.minhash_pack(idx, nnz, a, b, bits=bits)
        want = fe.minhash_pack_plain(idx, nnz, a, b, bits=bits)
        torch.cuda.synchronize()
        err = int_err(torch, got, want)
        errs["minhash_pack"] = max(errs.get("minhash_pack", 0), err)
        print(f"kernels: minhash_pack k={K} b={bits} rows={ROWS} "
              f"nnz 0..{m}: bytes equal={err == 0}")
        if err:
            fail(f"minhash_pack b={bits} differs from its plain version")

    oa, ob = OPHHash.make(K, 1).params(dev)
    for bits in (1, 2, 4, 8):
        for densify in (True, False):
            got = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=bits,
                              densify=densify)
            want = fe.oph_pack_plain(idx, nnz, oa, ob, k=K, bits=bits,
                                     densify=densify)
            torch.cuda.synchronize()
            err = max(int_err(torch, got[0], want[0]),
                      int_err(torch, got[1], want[1]))
            errs["oph_pack"] = max(errs.get("oph_pack", 0), err)
            print(f"kernels: oph_pack k={K} b={bits} densify={densify} "
                  f"rows={ROWS} nnz 0..{m}: codes and mask equal="
                  f"{err == 0}")
            if err:
                fail(f"oph_pack b={bits} densify={densify} differs")

    codes = rng.integers(0, 1 << B, size=(ROWS, K)).astype(np.uint16)
    packed = torch.from_numpy(pack_codes(codes, B)).to(dev)
    mask = rng.random((ROWS, K)) < 0.3
    mask[0] = True
    empty = torch.from_numpy(np.packbits(mask, axis=1)).to(dev)
    for c in (1, 4):
        table = torch.from_numpy(
            rng.normal(size=(K, 1 << B, c)).astype(np.float32)).to(dev)
        for em in (None, empty):
            got = bl.bbit_linear_packed_fwd(packed, table, k=K, bits=B,
                                            empty=em)
            again = bl.bbit_linear_packed_fwd(packed, table, k=K, bits=B,
                                              empty=em)
            want = bl.bbit_linear_packed_fwd_plain(packed, table, k=K,
                                                   bits=B, empty=em)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["bbit_linear_packed_fwd"] = max(
                errs.get("bbit_linear_packed_fwd", 0.0), err)
            ok = torch.allclose(got, want, **TOL)
            print(f"kernels: bbit_linear_packed_fwd k={K} b={B} C={c} "
                  f"mask={em is not None}: max_abs_err={err} "
                  f"allclose(1e-5)={ok} run-to-run equal="
                  f"{torch.equal(got, again)}")
            if not ok or not torch.equal(got, again):
                fail("bbit_linear_packed_fwd differs from its plain version")
    edge = {}
    check_linear_kernels(torch, dev, rng, edge)
    check_vw_kernel(torch, dev, rng, edge)
    return errs, edge


def _close(torch, name, errs, got, want, again=None, scale=None, **tol):
    """Records the max abs error; fails unless allclose (or, given the
    sums of absolute terms ``scale``, within 1e-5 of them: the error
    bound of a float32 sum taken in another order), and, given
    ``again``, unless ``again`` has the same bytes as ``got``."""
    diff = (got - want).abs()
    err = float(diff.max()) if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if scale is None:
        ok = torch.allclose(got, want, **(tol or TOL))
    else:
        ok = bool((diff <= DW_SUM_TOL * scale + 1e-6).all())
    same = again is None or torch.equal(got.view(torch.int32),
                                        again.view(torch.int32))
    if not ok or not same:
        fail(f"{name} differs from its plain version (max_abs_err={err}, "
             f"run-to-run equal={same})")
    return err


def check_linear_kernels(torch, dev, rng, errs):
    """B7, B8 (widened codes) and B6 (packed) against their plain versions
    at ragged k and n; B6 and B8 twice for the same bytes.  The train
    phase checks them again at its own shapes (check_train_shapes)."""
    from repro_torch.core.bbit import pack_codes
    from repro_torch.kernels import bbit_linear as bl
    n, k = 4099, 37
    for bits in (1, 2, 4, 8, 12):
        v = 1 << bits
        codes_np = rng.integers(0, v, size=(n, k)).astype(np.int32)
        codes = torch.from_numpy(codes_np).to(dev)
        for c in (1, 4):
            table = torch.from_numpy(
                rng.normal(size=(k, v, c)).astype(np.float32)).to(dev)
            dout = torch.from_numpy(
                rng.normal(size=(n, c)).astype(np.float32)).to(dev)
            e7 = _close(torch, "bbit_linear_fwd",
                        errs, bl.bbit_linear_fwd(codes, table),
                        bl.bbit_linear_fwd_plain(codes, table),
                        bl.bbit_linear_fwd(codes, table))
            e8 = _close(torch, "bbit_linear_bwd_dw", errs,
                        bl.bbit_linear_bwd_dw(codes, dout, v),
                        bl.bbit_linear_bwd_dw_plain(codes, dout, v),
                        bl.bbit_linear_bwd_dw(codes, dout, v),
                        scale=bl.bbit_linear_bwd_dw_plain(codes, dout.abs(),
                                                          v))
            line = (f"kernels: bbit_linear_fwd / bwd_dw k={k} n={n} b={bits}"
                    f" C={c}: max_abs_err={e7} / {e8} within tolerance "
                    "run-to-run equal=True")
            if bits > 8:
                print(line)
                continue
            packed = torch.from_numpy(
                pack_codes(codes_np.astype(np.uint16), bits)).to(dev)
            mask = rng.random((n, k)) < 0.3
            mask[0] = True
            empty = torch.from_numpy(np.packbits(mask, axis=1)).to(dev)
            e6 = []
            for em in (None, empty):
                kw = dict(k=k, bits=bits, empty=em)
                e6.append(_close(
                    torch, "bbit_linear_packed_bwd_dw", errs,
                    bl.bbit_linear_packed_bwd_dw(packed, dout, v, **kw),
                    bl.bbit_linear_packed_bwd_dw_plain(packed, dout, v, **kw),
                    bl.bbit_linear_packed_bwd_dw(packed, dout, v, **kw),
                    scale=bl.bbit_linear_packed_bwd_dw_plain(
                        packed, dout.abs(), v, **kw)))
            print(f"{line}; bbit_linear_packed_bwd_dw without / with mask: "
                  f"max_abs_err={e6[0]} / {e6[1]} within tolerance "
                  "run-to-run equal=True")


def check_vw_kernel(torch, dev, rng, errs):
    """B9: byte for byte with values of ones, allclose with random
    values, the same bytes on two calls."""
    from repro_torch.kernels import vw_sketch as vw
    n, mx = 256, 3000
    idx = torch.from_numpy(
        rng.integers(0, 1 << 31, size=(n, mx)).astype(np.int32)).to(dev)
    nnz_np = rng.integers(0, mx + 1, size=n).astype(np.int32)
    nnz_np[:2] = [0, mx]
    nnz = torch.from_numpy(nnz_np).to(dev)
    ones = torch.ones((n, mx), dtype=torch.float32, device=dev)
    vals = torch.from_numpy(
        rng.normal(size=(n, mx)).astype(np.float32)).to(dev)
    for m in (2, 64, 256, 1024, VW_WIDE):
        got = vw.vw_sketch(idx, ones, nnz, m, seed=VW_SEED)
        want = vw.vw_sketch_plain(idx, ones, nnz, m, seed=VW_SEED)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        if not same:
            fail(f"vw_sketch m={m} with ones differs from its plain version")
        err = _close(torch, "vw_sketch", errs,
                     vw.vw_sketch(idx, vals, nnz, m, seed=VW_SEED),
                     vw.vw_sketch_plain(idx, vals, nnz, m, seed=VW_SEED),
                     vw.vw_sketch(idx, vals, nnz, m, seed=VW_SEED),
                     rtol=1e-5, atol=1e-4)
        print(f"kernels: vw_sketch rows={n} nnz 0..{mx} m={m}: ones bytes "
              f"equal={same}; random values max_abs_err={err} "
              "allclose(1e-5, 1e-4)=True run-to-run equal=True")


def make_corpus(n: int, seed: int):
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    cfg = SynthRcv1Config(seed=seed, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=3000, max_triples_per_doc=1500)
    rows, _ = generate_arrays(n, cfg)
    return rows


def numpy_scores(scheme, docs, table, bias):
    """Host reference: the numpy encode and a float64 gather-sum."""
    from repro_torch.core.bbit import unpack_codes
    from repro_torch.data.packing import pad_rows
    idx, nnz = pad_rows(docs, pad_to_multiple=1)
    packed, empty = scheme.encode_packed_numpy(idx, nnz, B)
    codes = unpack_codes(packed, K, B).astype(np.int64)
    gathered = table[np.arange(K)[None, :], codes].astype(np.float64)
    if empty is not None:
        gathered[np.unpackbits(empty, axis=1, count=K).astype(bool)] = 0.0
    return gathered.sum(axis=1)[:, 0] + bias[0], packed, empty, idx, nnz


def plain_scores(torch, dev, eng, docs):
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe
    a, b = eng.scheme.hash_params(dev)
    params = eng.params
    out = []
    for lo in range(0, len(docs), ROWS):
        idx, nnz = pad_rows(docs[lo: lo + ROWS], pad_to_multiple=1)
        idx = torch.from_numpy(idx).to(dev)
        nnz = torch.from_numpy(nnz).to(dev)
        if eng.scheme.name == "minwise":
            packed = fe.minhash_pack_plain(idx, nnz, a, b, bits=B)
            empty = None
        else:
            packed, empty = fe.oph_pack_plain(idx, nnz, a, b, k=K, bits=B,
                                              densify=eng.scheme.densify)
            empty = None if eng.scheme.densify else empty
        logits = bl.bbit_linear_packed_fwd_plain(packed, params["table"],
                                                 k=K, bits=B, empty=empty)
        out.append((logits + params["bias"])[:, 0].cpu().numpy())
    return np.concatenate(out)


def serve_pass(eng, docs):
    futs = eng.submit_many(docs)
    eng.flush()
    return [f.result(timeout=300) for f in futs]


def serve_rate(eng, docs) -> dict:
    """Documents per second of submit_many + flush passes over ``docs``,
    repeated for at least RATE_WINDOW_S seconds: the median and spread of
    the per-pass rates, and the rate of the whole window."""
    rates = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < RATE_WINDOW_S or len(rates) < 10:
        t0 = time.perf_counter()
        served = serve_pass(eng, docs)
        rates.append(len(served) / (time.perf_counter() - t0))
    seconds = time.perf_counter() - t_start
    p10, med, p90 = (float(x) for x in np.percentile(rates, [10, 50, 90]))
    return {"passes": len(rates), "seconds": seconds,
            "window": len(rates) * len(docs) / seconds, "median": med,
            "p10": p10, "p90": p90, "min": min(rates), "max": max(rates)}


def profiled(torch, fn):
    """Runs ``fn`` under torch.profiler → (its result, {"wall_ms",
    "device_ms", "top", "host_top"}): the wall time, the device time per
    device-side event (kernels, copies), and the host ops with the most
    self CPU time (ms).  A CPU op's self device time repeats the time of
    the kernels it launched, so only device events are summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_us, host_us = {}, {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0) or 0)
        if us > 0 and e.device_type != DeviceType.CPU:
            ops_us[e.key[:70]] = us
        elif e.device_type == DeviceType.CPU:
            host_us[e.key[:70]] = (e.self_cpu_time_total / 1e3, e.count)
    return result, {"wall_ms": wall_ms,
                    "device_ms": sum(ops_us.values()) / 1e3,
                    "top": sorted(ops_us.items(), key=lambda kv: -kv[1])[:8],
                    "host_top": sorted(host_us.items(),
                                       key=lambda kv: -kv[1][0])[:8]}


def phase_engine(torch, dev, docs, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models.linear import BBitLinearConfig, init_bbit_linear
    from repro_torch.serving import HashedClassifierEngine

    cfg = BBitLinearConfig(k=K, b=B, n_classes=N_CLASSES)
    launches = {name: 0 for name in KERNELS}
    docs_per_s, profiles = {}, {}
    for scheme in ("minwise", "oph", "oph_zero"):
        gen = torch.Generator().manual_seed(0)
        params = init_bbit_linear(cfg, gen, device=dev)
        params["bias"] = (0.1 * torch.randn(1, generator=gen)).to(dev)
        with HashedClassifierEngine(params, cfg, seed=1, scheme=scheme,
                                    device=dev, max_batch=ROWS,
                                    nnz_buckets=NNZ_BUCKETS,
                                    row_buckets=(1, ROWS)) as eng:
            half = len(docs) // 2
            ops.reset_counts()
            futs = [eng.submit(d) for d in docs[:half]]
            futs += eng.submit_many(docs[half:])
            eng.flush()
            served = np.asarray([f.result(timeout=300) for f in futs],
                                np.float32)
            direct = eng.score_docs(docs)
            counts = ops.counts()

            encode = "minhash_pack" if scheme == "minwise" else "oph_pack"
            for name in (encode, "bbit_linear_packed_fwd"):
                if counts[name] < 1:
                    fail(f"{scheme}: kernel {name} was not launched")
                launches[name] += counts[name]
            stray = {f"{n}_plain": c.value for n, c in ops.PLAIN.items()
                     if c.value}
            if stray:
                fail(f"{scheme}: the main path left the kernels: {stray}")
            if served.shape != (len(docs),) or not np.isfinite(served).all():
                fail(f"{scheme}: scores not finite or of the wrong shape")
            if not np.array_equal(served, direct):
                fail(f"{scheme}: futures differ from score_docs")
            plain = plain_scores(torch, dev, eng, docs)
            err_plain = float(np.abs(served - plain).max())
            if not np.allclose(served, plain, **TOL):
                fail(f"{scheme}: kernels vs plain path {err_plain}")

            sub = docs[:ROWS]
            table = eng.params["table"].cpu().numpy()
            bias = eng.params["bias"].cpu().numpy()
            ref, ref_packed, ref_empty, idx, nnz = numpy_scores(
                eng.scheme, sub, table, bias)
            packed, empty = eng.scheme.encode_packed(
                torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev),
                B)
            bytes_equal = np.array_equal(packed.cpu().numpy(), ref_packed) \
                and (empty is None) == (ref_empty is None) \
                and (empty is None
                     or np.array_equal(empty.cpu().numpy(), ref_empty))
            err_ref = float(np.abs(served[:ROWS] - ref).max())
            if not bytes_equal or not np.allclose(served[:ROWS], ref, **TOL):
                fail(f"{scheme}: host numpy reference differs "
                     f"(bytes equal={bytes_equal}, max_abs_err={err_ref})")

            nnz_all = np.array([len(d) for d in docs])
            rate = serve_rate(eng, docs)
            docs_per_s[scheme] = rate
            _, prof = profiled(torch, lambda: serve_pass(eng, docs))
            profiles[scheme] = prof
            if prof["device_ms"] > 0:
                pass_ms = len(docs) / rate["median"] * 1e3
                prof["busy_share"] = prof["device_ms"] / pass_ms
                busy = (f"device busy {prof['device_ms']} ms in a profiled "
                        f"pass of {prof['wall_ms']} ms, share of an "
                        f"unprofiled pass ({pass_ms} ms) "
                        f"{prof['busy_share']}; top {prof['top']}")
            else:
                busy = "device busy: not measured (no device time traced)"
            print(f"engine: {scheme} profile: {busy}")
            print(f"engine: {scheme} k={K} b={B} docs={len(docs)} nnz "
                  f"{nnz_all.min()}..{nnz_all.max()} (mean "
                  f"{nnz_all.mean():.0f}) launches={counts[encode]}+"
                  f"{counts['bbit_linear_packed_fwd']} batches="
                  f"{eng.stats()['batches_run']} futures==score_docs "
                  f"vs plain max_abs_err={err_plain} vs numpy host ref "
                  f"max_abs_err={err_ref} bytes equal={bytes_equal} "
                  f"card={card}")
            print(f"engine: {scheme} docs/s over {rate['passes']} passes of "
                  f"{len(docs)} docs in {rate['seconds']} s: median "
                  f"{rate['median']} p10 {rate['p10']} p90 {rate['p90']} "
                  f"min {rate['min']} max {rate['max']} whole window "
                  f"{rate['window']} card={card}")
    return {"launches": launches, "docs_per_s": docs_per_s,
            "profiles": profiles}


def make_train_corpus():
    """examples/compare_vw_bbit.py's corpus settings, seed 11."""
    from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
    cfg = SynthRcv1Config(seed=TRAIN_SEED, topic_tokens=150,
                          background_frac=0.35, max_pairs_per_doc=4000,
                          max_triples_per_doc=2000)
    return generate_arrays(TRAIN_DOCS, cfg)


def sketch_corpus(torch, dev, rows, m: int, via_core: bool = False):
    """(n, m) VW sketches on the card, in length-sorted chunks of 256
    rows: ops.vw_sketch (B9), or core.vw.vw_hash_sparse (plain torch)."""
    from repro_torch.core.vw import vw_hash_sparse
    from repro_torch.data.hashed_dataset import _length_sorted_chunks
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import ops
    out = torch.empty((len(rows), m), dtype=torch.float32, device=dev)
    for sel in _length_sorted_chunks(rows, VW_CHUNK):
        idx, nnz = pad_rows([rows[i] for i in sel])
        idx = torch.from_numpy(idx).to(dev)
        nnz = torch.from_numpy(nnz).to(dev)
        if via_core:
            mask = (torch.arange(idx.shape[1], device=dev)[None, :]
                    < nnz[:, None])
            sk = vw_hash_sparse(idx, mask, None, m, seed=VW_SEED)
        else:
            ones = torch.ones(idx.shape, dtype=torch.float32, device=dev)
            sk = ops.vw_sketch(idx, ones, nnz, m, seed=VW_SEED)
        out[torch.from_numpy(sel).to(dev)] = sk
    return out


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_train(torch, dev, card: str, errs: dict):
    from repro_torch.data.hashed_dataset import preprocess_rows
    from repro_torch.kernels import ops
    from repro_torch.models.linear import BBitLinearConfig, VWLinearConfig
    from repro_torch.train.linear_trainer import (train_bbit_liblinear,
                                                  train_vw_liblinear)

    (rows, labels), gen_s = timed(torch, make_train_corpus)
    nnz_all = np.array([len(r) for r in rows])
    print(f"train: corpus {len(rows)} docs in {gen_s:.2f} s, nnz "
          f"{nnz_all.min()}..{nnz_all.max()} (mean {nnz_all.mean():.1f}, "
          f"total {nnz_all.sum()}), positive share {labels.mean():.4f}")
    n = TRAIN_ROWS
    cfg = BBitLinearConfig(k=K, b=B, n_classes=N_CLASSES)
    runs, codes = {}, {}

    ops.reset_counts()
    for scheme in ("minwise", "oph"):
        codes[scheme], sec = timed(torch, lambda: preprocess_rows(
            rows, k=K, b=B, scheme=scheme, seed=HASH_SEED,
            chunk=PREPROCESS_CHUNK, device=dev))
        print(f"train: preprocess_rows {scheme} k={K} b={B} docs="
              f"{len(rows)}: {sec:.3f} s ({len(rows) / sec:.0f} docs/s) "
              f"card={card}")
        for loss in ("logistic", "squared_hinge"):
            c = codes[scheme]
            res = train_bbit_liblinear(c[:n], labels[:n], c[n:], labels[n:],
                                       cfg, loss=loss, C=TRAIN_C,
                                       max_iter=TRAIN_ITERS, device=dev)
            runs[f"bbit {scheme} {loss}"] = res
    sketches = {}
    for m in (VW_EQUAL, VW_WIDE):
        sketches[m], sec = timed(torch, lambda: sketch_corpus(
            torch, dev, rows, m))
        print(f"train: vw sketches m={m} docs={len(rows)} via ops.vw_sketch:"
              f" {sec:.3f} s card={card}")
        sk = sketches[m]
        runs[f"vw m={m} logistic"] = train_vw_liblinear(
            sk[:n], labels[:n], sk[n:], labels[n:], VWLinearConfig(m=m),
            loss="logistic", C=TRAIN_C, max_iter=TRAIN_ITERS, device=dev)
    counts = ops.counts()

    for m in (VW_EQUAL, VW_WIDE):
        core = sketch_corpus(torch, dev, rows, m, via_core=True)
        vw_equal = torch.equal(sketches[m].view(torch.int32),
                               core.view(torch.int32))
        print(f"train: vw m={m} sketches of ops.vw_sketch vs "
              f"core.vw.vw_hash_sparse over all {len(rows)} docs: bytes "
              f"equal={vw_equal}")
        if not vw_equal:
            fail(f"B9 sketches differ from core.vw's at m={m}")
        del core
    for name, res in runs.items():
        print(f"train: {name} test_acc={res.test_acc} train_acc="
              f"{res.train_acc} tron_iters={res.n_iter} objective="
              f"{res.objective} seconds={res.train_seconds} card={card}")
        if not np.isfinite(res.objective):
            fail(f"{name}: objective not finite")
    for scheme in ("minwise", "oph"):
        if runs[f"bbit {scheme} logistic"].test_acc <= 0.9:
            fail(f"{scheme} logistic test accuracy <= 0.9")
        if runs[f"bbit {scheme} squared_hinge"].test_acc <= 0.85:
            fail(f"{scheme} squared hinge test accuracy <= 0.85")
        gap = (runs[f"bbit {scheme} logistic"].test_acc
               - runs[f"vw m={VW_EQUAL} logistic"].test_acc)
        print(f"train: b-bit {scheme} - VW m={VW_EQUAL} (equal storage, "
              f"{K * B} bits) test accuracy: {gap}")
        if gap <= 0.05:
            fail(f"b-bit {scheme} does not beat VW at equal storage by 0.05")
    for name in ("bbit_linear_fwd", "bbit_linear_bwd_dw", "vw_sketch",
                 "minhash", "oph"):
        if counts[name] < 1:
            fail(f"train: kernel {name} was not launched")
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if stray:
        fail(f"train: the main path left the kernels: {stray}")
    print(f"train: launches {json.dumps(counts)}")
    check_plan_builds("train", counts, sum(1 for name in runs
                                           if name.startswith("bbit")))
    plain_runs = {}
    for scheme in ("minwise", "oph"):
        for loss in ("logistic", "squared_hinge"):
            name = f"bbit {scheme} {loss}"
            plain_runs[name] = plain_fit(torch, dev, codes[scheme], labels,
                                         K, B, loss)
            same_fit("train", name, runs[name], plain_runs[name], card)

    c = codes["oph"]
    res, prof = profiled(torch, lambda: train_bbit_liblinear(
        c[:n], labels[:n], c[n:], labels[n:], cfg, loss="logistic",
        C=TRAIN_C, max_iter=TRAIN_ITERS, device=dev))
    if prof["device_ms"] <= 0:
        fail("the profiler traced no device time in the TRON fit")
    prof["tron_ms"] = res.train_seconds * 1e3
    unprofiled_ms = runs["bbit oph logistic"].train_seconds * 1e3
    prof["busy_share"] = prof["device_ms"] / unprofiled_ms
    print(f"train: profile of bbit oph logistic: device busy "
          f"{prof['device_ms']} ms in a profiled fit of {prof['wall_ms']} ms "
          f"(TRON {prof['tron_ms']} ms), share of the unprofiled TRON "
          f"({unprofiled_ms} ms) {prof['busy_share']}; top {prof['top']}")
    check_raw_encode(torch, dev, raw_chunk(torch, dev, rows), errs)
    check_train_shapes(torch, dev, rows, labels, codes, runs, errs)
    grad = gradient_step(torch, dev, rows[:STREAM_BATCH], labels,
                         runs["bbit oph logistic"].params, cfg, errs)
    summary = {"runs": fit_summary(runs), "plain_runs": fit_summary(plain_runs),
               "counts": counts, "grad": grad, "profile": prof}
    return summary, {"rows": rows, "labels": labels,
                     "codes": codes["minwise"],
                     "params": runs["bbit minwise logistic"].params,
                     "vw_wide": runs[f"vw m={VW_WIDE} logistic"]}


def fit_summary(runs: dict) -> dict:
    return {k: dict(test_acc=r.test_acc, train_acc=r.train_acc,
                    n_iter=r.n_iter, objective=r.objective,
                    seconds=r.train_seconds) for k, r in runs.items()}


def check_plan_builds(phase: str, counts: dict, fits: int) -> None:
    """B8 builds one plan per b-bit fit: TRON's ~51 dW calls of a fit run
    on its one training codes tensor."""
    builds = counts["bbit_linear_bwd_dw_plans"]
    print(f"{phase}: bbit_linear_bwd_dw plans built {builds} for {fits} "
          f"b-bit fits ({counts['bbit_linear_bwd_dw']} dW calls)")
    if builds != fits:
        fail(f"{phase}: {builds} B8 plans built for {fits} fits")


def plain_fit(torch, dev, codes, labels, k: int, b: int, loss: str):
    """``train_bbit_liblinear``'s fit with B7's plain version on the card
    (``gather_sum``, whose torch autograd backward stands in for B8) in
    place of the kernels: the same TRON, objective and data."""
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.models.linear import (BBitLinearConfig, _classes,
                                           _finish, init_bbit_linear)
    from repro_torch.train.linear_trainer import _fit, _on
    cfg = BBitLinearConfig(k=k, b=b, n_classes=N_CLASSES)
    n = TRAIN_ROWS

    def forward(p, c):
        return _finish(bl.bbit_linear_fwd_plain(c, p["table"]), p, cfg)

    return _fit(forward, lambda p, c: _classes(forward(p, c), N_CLASSES),
                init_bbit_linear(cfg, device=dev),
                _on(codes[:n], dev, torch.int32), labels[:n],
                _on(codes[n:], dev, torch.int32), labels[n:], loss=loss,
                C=TRAIN_C, max_iter=TRAIN_ITERS, dev=dev)


def same_fit(phase: str, name: str, res, plain, card: str) -> None:
    """A fit through the kernels takes the plain path's TRON iterations
    and ends within ``FIT_OBJECTIVE_RTOL`` of its objective."""
    rel = abs(res.objective - plain.objective) / max(abs(plain.objective),
                                                     1e-30)
    print(f"{phase}: {name} kernels vs plain path on the card: tron_iters="
          f"{res.n_iter} / {plain.n_iter} objective={res.objective} / "
          f"{plain.objective} (rel {rel:.3g}) test_acc={res.test_acc} / "
          f"{plain.test_acc} seconds={res.train_seconds} / "
          f"{plain.train_seconds} card={card}")
    if res.n_iter != plain.n_iter or rel > FIT_OBJECTIVE_RTOL:
        fail(f"{phase}: {name} through the kernels departs from the plain "
             "path")


def raw_chunk(torch, dev, rows, first: bool = False):
    """One chunk of ``preprocess_rows``' own, padded as it pads it: the
    first (the shortest documents), or the widest of the chunks that
    hold a full chunk's rows → (sel, idx, nnz, total nonzeros)."""
    from repro_torch.data.hashed_dataset import _length_sorted_chunks
    from repro_torch.data.packing import pad_rows
    chunks = list(_length_sorted_chunks(rows, PREPROCESS_CHUNK))
    full = [c for c in chunks if len(c) == len(chunks[0])]
    sel = chunks[0] if first else full[-1]
    idx, nnz = pad_rows([rows[i] for i in sel], bucket=True)
    return (sel, torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev),
            int(nnz.sum()))


def check_raw_encode(torch, dev, chunk, errs):
    """B3 at k=256 and k=500 and B4 at k=256, with the train and paper
    phases' hash seed, against their plain versions on one chunk of
    ``preprocess_rows``' own: the same words, and the same words on two
    calls."""
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import minhash as mh
    from repro_torch.kernels import oph as oph_k
    sel, idx, nnz, total = chunk
    cases = []
    for k in (K, PAPER_K):
        a, b = MultiplyShiftHash.make(k, HASH_SEED).params(dev)
        cases.append(("minhash", k, lambda a=a, b=b: mh.minhash(idx, nnz, a, b),
                      lambda a=a, b=b: mh.minhash_plain(idx, nnz, a, b)))
    oa, ob = OPHHash.make(K, HASH_SEED).params(dev)
    cases.append(("oph", K, lambda: oph_k.oph(idx, nnz, oa, ob, k=K),
                  lambda: oph_k.oph_plain(idx, nnz, oa, ob, k=K)))
    for name, k, kernel, plain in cases:
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = int_err(torch, got, want)
        same = torch.equal(got, again)
        errs[name] = max(errs.get(name, 0), err)
        print(f"check: {name} k={k} on one chunk of {len(sel)} docs (pad "
              f"{idx.shape[1]}, {total} nonzeros): words equal={err == 0} "
              f"run-to-run equal={same}")
        if err or not same:
            fail(f"{name} k={k} differs from its plain version")
        del got, again, want
    torch.cuda.empty_cache()


def logistic_dout(torch, logits, labels, scale: float):
    """d/dlogits of ``scale`` x the summed logistic loss: the dout that
    the objective's backward hands to B8 / B6."""
    y = 2.0 * labels.to(torch.float32)[:, None] - 1.0
    return (-scale * y * torch.sigmoid(-y * logits)).contiguous()


def check_train_shapes(torch, dev, rows, labels, codes, runs, errs):
    """B7, B8 and B6 (without mask) against their plain versions at the
    train phase's own shapes, on its codes, its trained tables and the
    objective's dout; B9 on one real chunk of 256 documents at m=64 and
    m=2^14.  B6 and B8 twice for the same bytes."""
    from repro_torch.core.bbit import pack_codes
    from repro_torch.data.hashed_dataset import _length_sorted_chunks
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import vw_sketch as vw
    v, n = 1 << B, TRAIN_ROWS
    y = torch.from_numpy(labels).to(dev)
    for scheme in ("minwise", "oph"):
        params = runs[f"bbit {scheme} logistic"].params
        table = params["table"].detach().contiguous()
        c_all = torch.from_numpy(codes[scheme].astype(np.int32)).to(dev)
        e7 = [_close(torch, "bbit_linear_fwd", errs,
                     bl.bbit_linear_fwd(x, table),
                     bl.bbit_linear_fwd_plain(x, table),
                     bl.bbit_linear_fwd(x, table))
              for x in (c_all[:n], c_all[n:].contiguous())]
        x = c_all[:n]
        logits = bl.bbit_linear_fwd_plain(x, table) + params["bias"].detach()
        dout = logistic_dout(torch, logits, y[:n], TRAIN_C)
        e8 = _close(torch, "bbit_linear_bwd_dw", errs,
                    bl.bbit_linear_bwd_dw(x, dout, v),
                    bl.bbit_linear_bwd_dw_plain(x, dout, v),
                    bl.bbit_linear_bwd_dw(x, dout, v),
                    scale=bl.bbit_linear_bwd_dw_plain(x, dout.abs(), v))
        e6 = {}
        for rows_n in (STREAM_BATCH, TRAIN_ROWS):
            packed = torch.from_numpy(pack_codes(
                codes[scheme][:rows_n], B)).to(dev)
            d = dout[:rows_n].contiguous()
            kw = dict(k=K, bits=B)
            e6[rows_n] = _close(
                torch, "bbit_linear_packed_bwd_dw", errs,
                bl.bbit_linear_packed_bwd_dw(packed, d, v, **kw),
                bl.bbit_linear_packed_bwd_dw_plain(packed, d, v, **kw),
                bl.bbit_linear_packed_bwd_dw(packed, d, v, **kw),
                scale=bl.bbit_linear_packed_bwd_dw_plain(packed, d.abs(), v,
                                                         **kw))
        print(f"check: {scheme} trained table, k={K} V={v} C=1: "
              f"bbit_linear_fwd n={n} / {len(labels) - n} max_abs_err="
              f"{e7[0]} / {e7[1]} allclose(1e-5); bbit_linear_bwd_dw n={n} "
              f"(logistic dout) max_abs_err={e8}; bbit_linear_packed_bwd_dw "
              f"without mask n={STREAM_BATCH} / {n} max_abs_err="
              f"{e6[STREAM_BATCH]} / {e6[n]}; dW within 1e-5 of each bin's "
              "sum of |terms|, run-to-run equal=True")
    chunks = list(_length_sorted_chunks(rows, VW_CHUNK))
    sel = chunks[len(chunks) // 2]
    idx, nnz = pad_rows([rows[i] for i in sel])
    idx = torch.from_numpy(idx).to(dev)
    nnz = torch.from_numpy(nnz).to(dev)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    for m in (VW_EQUAL, VW_WIDE):
        got = vw.vw_sketch(idx, ones, nnz, m, seed=VW_SEED)
        want = vw.vw_sketch_plain(idx, ones, nnz, m, seed=VW_SEED)
        err = _close(torch, "vw_sketch", errs, got, want,
                     vw.vw_sketch(idx, ones, nnz, m, seed=VW_SEED))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"vw_sketch m={m} on a real chunk differs from its plain "
                 "version")
        print(f"check: vw_sketch one chunk of {len(sel)} docs (pad "
              f"{idx.shape[1]}) m={m}: bytes equal=True max_abs_err={err}")


def gradient_step(torch, dev, docs, labels, params, cfg, errs) -> dict:
    """One gradient of the mean logistic loss over bbit_logits_packed on
    one stream batch of packed training rows (B5 + B6), for oph and
    oph_zero, against the gradient through widened codes (B7 + B8 for
    oph, the plain masked gather for oph_zero); and B6 alone on the same
    packed rows, mask and loss dout against its plain version."""
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.core.bbit import unpack_codes_torch, unpack_mask_torch
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import ops
    from repro_torch.models.linear import bbit_logits, bbit_logits_packed
    from repro_torch.train.losses import mean_loss_fn

    idx, nnz = pad_rows(docs)
    idx = torch.from_numpy(idx).to(dev)
    nnz = torch.from_numpy(nnz).to(dev)
    y = torch.from_numpy(labels[:len(docs)]).to(dev)
    out = {"launches": {}}
    for scheme in ("oph", "oph_zero"):
        packed, empty = make_scheme(scheme, K, HASH_SEED).encode_packed(
            idx, nnz, B)
        kw = dict(k=K, bits=B, empty=empty)
        table = params["table"].detach()
        logits = (bl.bbit_linear_packed_fwd_plain(packed, table, **kw)
                  + params["bias"].detach())
        dout = logistic_dout(torch, logits, y, 1.0 / len(docs))
        e6 = _close(torch, "bbit_linear_packed_bwd_dw", errs,
                    bl.bbit_linear_packed_bwd_dw(packed, dout, 1 << B, **kw),
                    bl.bbit_linear_packed_bwd_dw_plain(packed, dout, 1 << B,
                                                       **kw),
                    bl.bbit_linear_packed_bwd_dw(packed, dout, 1 << B, **kw),
                    scale=bl.bbit_linear_packed_bwd_dw_plain(
                        packed, dout.abs(), 1 << B, **kw))
        print(f"check: bbit_linear_packed_bwd_dw {scheme} {len(docs)} packed "
              f"rows mask={empty is not None} (mean logistic dout): "
              f"max_abs_err={e6} within 1e-5 of each bin's sum of |terms|, "
              "run-to-run equal=True")
        grads = []
        for widened in (False, True):
            p = {name: t.detach().clone().requires_grad_(True)
                 for name, t in params.items()}
            if widened:
                x = unpack_codes_torch(packed, K, B).to(torch.int32)
                mask = None if empty is None else unpack_mask_torch(empty, K)
                fwd = lambda q, c, mask=mask: bbit_logits(q, c, cfg,
                                                          empty=mask)
            else:
                x = packed
                fwd = lambda q, c, empty=empty: bbit_logits_packed(
                    q, c, cfg, empty_packed=empty)
            ops.reset_counts()
            mean_loss_fn(fwd, "logistic")(p, x, y).backward()
            torch.cuda.synchronize()
            counts = ops.counts()
            if not widened:
                for name in ("bbit_linear_packed_fwd",
                             "bbit_linear_packed_bwd_dw"):
                    if counts[name] < 1 or counts[f"{name}_plain"]:
                        fail(f"gradient {scheme}: {name} not launched")
                    out["launches"][name] = (out["launches"].get(name, 0)
                                             + counts[name])
            grads.append({name: t.grad for name, t in p.items()})
        err = max(float((grads[0][n] - grads[1][n]).abs().max())
                  for n in grads[0])
        ok = all(torch.allclose(grads[0][n], grads[1][n], **GRAD_TOL)
                 for n in grads[0])
        out[scheme] = err
        print(f"gradient: {scheme} mean logistic loss over "
              f"{len(docs)} packed rows (B5 + B6{' + mask' if empty is not None else ''})"
              f" vs widened codes ({'B7 + B8' if empty is None else 'plain masked gather'}):"
              f" max_abs_err={err} allclose(rtol 1e-5, atol 1e-8)={ok}")
        if not ok:
            fail(f"gradient {scheme}: packed and widened gradients differ")
    return out


def fit_line(res) -> dict:
    return dict(seconds=res.train_seconds, steps=res.n_steps,
                rows=res.examples_seen,
                rows_per_s=res.examples_seen / res.train_seconds,
                progressive_acc=res.progressive_acc,
                shards=res.shards_processed)


def phase_stream(torch, dev, card: str, data: dict):
    """The paper's streaming path at configs/rcv1_oph.py's width on the
    train phase's corpus, cut to 8 shards of 2,000 rows; its archives are
    written under build/ and removed after.  → (its record, the serve
    phase's handover: the uninterrupted fit's checkpoint directory copied
    to SERVE_DIR, its held-out accuracy and eval params)."""
    work = os.path.join(ROOT, "build", "chip_smoke_stream")
    shutil.rmtree(work, ignore_errors=True)
    try:
        out, handover = stream_in(torch, dev, card, data, work)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    # the dp and bf16 phases fit the same archive; main() removes it
    handover["stream_work"] = work
    return out, handover


def stream_in(torch, dev, card: str, data: dict, work: str):
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import (
        load_hashed, preprocess_and_save, preprocess_rows,
        preprocess_rows_packed, shard_row_counts, verify_shard)
    from repro_torch.ft import faults
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.kernels import ops
    from repro_torch.models.linear import bbit_scores_packed
    from repro_torch.train.linear_trainer import train_bbit_sgd
    from repro_torch.train.metrics import accuracy, trees_bitwise_equal
    from repro_torch.train.streaming import fit_streaming
    from repro_torch.train.supervisor import run_supervised

    rows, labels = data["rows"], data["labels"]
    n = TRAIN_ROWS
    cfg = CONFIG.linear_config()
    kw = CONFIG.stream_kwargs(seed=CONFIG.seed)
    if ((cfg.k, cfg.b, CONFIG.scheme, kw["batch_size"])
            != (K, B, "oph", STREAM_BATCH)):
        fail(f"stream: configs/rcv1_oph.py is not k={K}, b={B}, oph, "
             f"batch {STREAM_BATCH}")
    out = {"card": card, "settings": dict(kw, shards=STREAM_SHARDS,
                            chunk=CONFIG.preprocess_chunk,
                            crash_step=STREAM_CRASH_STEP)}
    ckpt_root = os.path.join(work, "ckpt")

    # -- the main path on the card: every launch counted from here ----
    ops.reset_counts()
    roots, pre_s = {}, {}
    for scheme in ("oph", "minwise", "oph_zero"):
        roots[scheme] = os.path.join(work, scheme)
        stats, pre_s[scheme] = timed(torch, lambda: preprocess_and_save(
            roots[scheme], rows[:n], labels[:n], K, B, scheme=scheme,
            seed=HASH_SEED, n_shards=STREAM_SHARDS,
            chunk=CONFIG.preprocess_chunk, device=dev))
        print(f"stream: preprocess_and_save {scheme} {n} docs into "
              f"{STREAM_SHARDS} shards (chunk {CONFIG.preprocess_chunk}): "
              f"{pre_s[scheme]} s ({n / pre_s[scheme]} docs/s, "
              f"{stats['mnnz_per_s']} M nonzeros/s) card={card}")
    out["preprocess_s"] = pre_s
    counts_rows = shard_row_counts(roots["oph"])
    if counts_rows != [n // STREAM_SHARDS] * STREAM_SHARDS:
        fail(f"stream: shard rows {counts_rows}")
    codes = {}
    for scheme, root in roots.items():
        codes[scheme] = load_hashed(root)[0]
        raw = preprocess_rows(rows[:n], K, B, scheme=scheme, seed=HASH_SEED,
                              chunk=PREPROCESS_CHUNK, device=dev)
        same = np.array_equal(codes[scheme], raw)
        fsck = [verify_shard(root, s) for s in range(STREAM_SHARDS)]
        print(f"stream: {scheme} archive codes vs preprocess_rows (the raw "
              f"encode, {'B3' if scheme == 'minwise' else 'B4'}) over "
              f"{n} rows: bytes equal={same}; verify_shard passed on "
              f"{sum(f is not None for f in fsck)} of {STREAM_SHARDS} shards")
        if not same or any(f is None for f in fsck):
            fail(f"stream: the {scheme} archive departs from the raw route")

    def fit(root=roots["oph"], **extra):
        return fit_streaming(root, cfg, device=dev, **dict(kw, **extra))

    steps_wd = StepWatchdog(window=STREAM_STEPS)
    runs = {"uninterrupted": fit(ckpt_dir=os.path.join(ckpt_root, "u"),
                                 watchdog=steps_wd)}
    plan = faults.FaultPlan([faults.FaultEvent(
        site="train_step", step=STREAM_CRASH_STEP, times=1)])
    with faults.arm(plan):
        sup, sup_s = timed(torch, lambda: run_supervised(
            roots["oph"], cfg, policy=CONFIG.restart_policy(), device=dev,
            ckpt_dir=os.path.join(ckpt_root, "s"), **kw))
    runs["supervised"] = sup.result
    runs["inline"] = fit(prefetch=0)
    runs["profiled"], prof = profiled(torch, lambda: fit(
        ckpt_dir=os.path.join(ckpt_root, "p")))
    runs["oph_zero"] = fit(roots["oph_zero"])
    held, _ = preprocess_rows_packed(rows[n:], K, B, scheme="oph",
                                     seed=HASH_SEED, device=dev)
    with torch.no_grad():
        scores = bbit_scores_packed(runs["uninterrupted"].eval_params,
                                    torch.from_numpy(held).to(dev), cfg)
    test_acc = accuracy(scores > 0, labels[n:])
    test_codes = preprocess_rows(rows[n:], K, B, scheme="oph",
                                 seed=HASH_SEED, chunk=PREPROCESS_CHUNK,
                                 device=dev)
    sgd = train_bbit_sgd(codes["oph"], labels[:n], test_codes, labels[n:],
                         cfg, epochs=kw["epochs"],
                         batch_size=kw["batch_size"], lr=kw["lr"],
                         seed=CONFIG.seed, device=dev)
    torch.cuda.synchronize()
    counts = ops.counts()
    # -- end of the main path -------------------------------------------

    for name, res in runs.items():
        line = fit_line(res)
        out[name] = line
        print(f"stream: fit {name} seconds={line['seconds']} steps="
              f"{line['steps']} rows={line['rows']} rows_per_s="
              f"{line['rows_per_s']} progressive_acc="
              f"{line['progressive_acc']} card={card}")
    u = runs["uninterrupted"]
    step_ms = [t * 1e3 for t in steps_wd.window]
    out["uninterrupted"].update(
        step_ms_median=float(np.median(step_ms)), step_ms_max=max(step_ms),
        between_steps_ms=u.train_seconds * 1e3 - sum(step_ms))
    print(f"stream: uninterrupted fit's steps on the host (enqueue, "
          f"StepWatchdog): median {out['uninterrupted']['step_ms_median']} "
          f"ms, max {out['uninterrupted']['step_ms_max']} ms, sum "
          f"{sum(step_ms)} ms; between steps (batches, hit reads, "
          f"checkpoints) {out['uninterrupted']['between_steps_ms']} ms")
    if u.n_steps != STREAM_STEPS or u.examples_seen != n or not u.completed:
        fail(f"stream: {u.n_steps} steps over {u.examples_seen} rows")
    out["test_acc"] = test_acc
    print(f"stream: held-out accuracy of the uninterrupted fit's eval "
          f"params over {len(rows) - n} rows (B2 encode, B5 scores): "
          f"{test_acc}")
    if test_acc <= 0.9:
        fail(f"stream: held-out accuracy {test_acc} <= 0.9")
    # the serve phase's weights: the uninterrupted fit's published
    # snapshots, and its training state without them (a reload from that
    # must be refused)
    import shutil
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    fit_dir = os.path.join(ckpt_root, "u")
    handover = {"ckpt_dir": os.path.join(SERVE_DIR, "ckpt"),
                "state_dir": os.path.join(SERVE_DIR, "state"),
                "empty_dir": os.path.join(SERVE_DIR, "empty"),
                "oph_root": roots["oph"],
                "test_acc": test_acc,
                "eval_params": {name: t.cpu().numpy() for name, t
                                in u.eval_params.items()}}
    shutil.copytree(fit_dir, handover["ckpt_dir"])
    shutil.copytree(fit_dir, handover["state_dir"],
                    ignore=shutil.ignore_patterns("serve"))
    os.makedirs(handover["empty_dir"])
    out["supervised"].update(restarts=sup.restarts, wall_s=sup_s,
                             crashes=[c.error for c in sup.crashes],
                             backoff_s=[c.backoff_s for c in sup.crashes],
                             recover_s=[c.recover_s for c in sup.crashes])
    for name in ("supervised", "inline", "profiled"):
        same = (trees_bitwise_equal(u.params, runs[name].params)
                and trees_bitwise_equal(u.avg_params, runs[name].avg_params)
                and fit_line(u)["progressive_acc"]
                == fit_line(runs[name])["progressive_acc"])
        print(f"stream: {name} fit bitwise equal to the uninterrupted "
              f"one (params, average, progressive accuracy)={same}")
        if not same:
            fail(f"stream: the {name} fit departs from the uninterrupted")
    print(f"stream: supervised restarts={sup.restarts} after a crash at "
          f"step {STREAM_CRASH_STEP} (fired {plan.events[0].fired}), "
          f"backoff {out['supervised']['backoff_s']} s, recovery "
          f"{out['supervised']['recover_s']} s, run_supervised {sup_s} s "
          f"in all")
    if sup.restarts != 1 or plan.events[0].fired != 1:
        fail(f"stream: {sup.restarts} restarts for one injected crash")
    if runs["oph_zero"].progressive_acc <= 0.5:
        fail("stream: oph_zero progressive accuracy <= 0.5")
    prof["busy_share"] = prof["device_ms"] / (
        runs["uninterrupted"].train_seconds * 1e3)
    out["profile"] = prof
    print(f"stream: profile of the uninterrupted fit: device busy "
          f"{prof['device_ms']} ms in a profiled fit of {prof['wall_ms']} ms"
          f", share of the unprofiled fit "
          f"({runs['uninterrupted'].train_seconds * 1e3} ms) "
          f"{prof['busy_share']}; top {prof['top']}; host top (self ms, "
          f"calls) {prof['host_top']} card={card}")
    out["sgd"] = dict(seconds=sgd.train_seconds, steps=sgd.n_iter,
                      test_acc=sgd.test_acc, train_acc=sgd.train_acc,
                      plans=counts["bbit_linear_bwd_dw_plans"])
    print(f"stream: in-memory SGD baseline (train_bbit_sgd, B7 + B8) "
          f"{json.dumps(out['sgd'])}: B8 built one plan a minibatch "
          f"({counts['bbit_linear_bwd_dw_plans']} for "
          f"{counts['bbit_linear_bwd_dw']} dW calls) card={card}")
    need = ("minhash_pack", "oph_pack", "minhash", "oph",
            "bbit_linear_packed_fwd", "bbit_linear_packed_bwd_dw",
            "bbit_linear_fwd", "bbit_linear_bwd_dw")
    missing = [name for name in need if counts[name] < 1]
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    print(f"stream: launches {json.dumps(counts)}")
    if missing or stray:
        fail(f"stream: kernels not launched {missing}, plain calls {stray}")
    out["counts"] = counts

    out["turns"] = stream_turns(torch, dev, card, rows[:n], roots["oph"],
                                cfg, kw, CONFIG.preprocess_chunk,
                                os.path.join(work, "turns"))

    # -- the same fit on the CPU (the kernels' plain versions) ----------
    cpu = fit_streaming(roots["oph"], cfg, device="cpu", **kw)
    err = max(float((u.params[k].cpu() - cpu.params[k]).abs().max())
              for k in u.params)
    close = all(torch.allclose(u.params[k].cpu(), cpu.params[k],
                               **STREAM_CPU_TOL) for k in u.params)
    out["cpu"] = dict(fit_line(cpu), params_max_abs_err=err)
    print(f"stream: cpu fit steps={cpu.n_steps} rows={cpu.examples_seen} "
          f"progressive_acc={cpu.progressive_acc} (card "
          f"{u.progressive_acc}); params max_abs_err={err} allclose(rtol "
          f"1e-4, atol 1e-5)={close}; {cpu.train_seconds} s on the host")
    if ((cpu.n_steps, cpu.examples_seen) != (u.n_steps, u.examples_seen)
            or not close
            or abs(cpu.progressive_acc - u.progressive_acc) > 1e-3):
        fail("stream: the card's fit departs from the CPU's")
    out["cpu"]["gap"] = stream_gap(torch, dev, roots["oph"], cfg, kw, u, cpu)
    return out, handover


def stream_turns(torch, dev, card: str, rows, root: str, cfg, kw: dict,
                 chunk: int, work: str) -> dict:
    """Seconds in turns over the stream phase's documents and archive:
    the packed oph encode with one chunk in flight or PIPELINE_DEPTH, and
    the fit with prefetch 0 or 2, each with checkpoints every 4 shards (a
    fresh directory a fit) and without; every fit's steps timed on the
    host by a StepWatchdog, the rest of its seconds between steps."""
    from repro_torch.data import hashed_dataset as hd
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.train.streaming import fit_streaming
    kept = hd.PIPELINE_DEPTH
    encode = {1: [], kept: []}
    try:
        for depth in (1, kept, kept, 1, 1, kept):
            hd.PIPELINE_DEPTH = depth
            _, sec = timed(torch, lambda: sum(
                len(sel) for sel, _, _ in hd._stream_encoded(
                    rows, K, B, scheme="oph", family="multiply_shift",
                    seed=HASH_SEED, chunk=chunk,
                    packed=True, dev=dev)))
            encode[depth].append(sec)
    finally:
        hd.PIPELINE_DEPTH = kept
    print(f"stream: oph packed encode of {len(rows)} docs, seconds in turns "
          f"1/{kept}/{kept}/1/1/{kept} chunks in flight: 1 {encode[1]}, "
          f"{kept} {encode[kept]} card={card}")

    arms = [(2, True), (0, True), (2, False), (0, False)]
    fits = {f"prefetch{p}_{'ckpt' if c else 'none'}": [] for p, c in arms}
    for turn, order in enumerate((arms, arms[::-1], arms)):
        for p, c in order:
            wd = StepWatchdog(window=STREAM_STEPS)
            res = fit_streaming(
                root, cfg, device=dev, **dict(
                    kw, prefetch=p, watchdog=wd,
                    ckpt_dir=os.path.join(work, f"{turn}_{p}") if c
                    else None))
            steps_s = sum(wd.window)
            fits[f"prefetch{p}_{'ckpt' if c else 'none'}"].append(dict(
                seconds=res.train_seconds, steps_s=steps_s,
                between_s=res.train_seconds - steps_s))
    for name, runs in fits.items():
        print(f"stream: fit {name} in turns (2c/0c/2n/0n, reversed, again): "
              f"seconds {[r['seconds'] for r in runs]}, host steps "
              f"{[r['steps_s'] for r in runs]}, between steps "
              f"{[r['between_s'] for r in runs]} card={card}")
    return {"encode_s": encode, "fits": fits}


def stream_gap(torch, dev, root: str, cfg, kw: dict, u, cpu) -> dict:
    """Where the card's oph fit and the CPU's part, and why.  The share of
    the allclose limit, |card - cpu| / (atol + rtol·|cpu|), at its largest;
    then both fits replayed step by step from the same start over the same
    batches with the fit's own loss, step and batch stream (the replay
    must end on each fit's bits).  After each step: the largest gap; the
    largest difference of the card's gradient (B5 + B6) from the plain
    versions' on the CPU at the card's params, and of B6 from its plain
    version on the card on the same rows and dout.  At the element of the
    final largest gap, each step's gradient on both sides, B6's and the
    plain version's sum there, the L2 term, the rows that hit it and how
    far their douts cancel (|sum| / sum of |dout|), and AdamW's
    m̂ / (sqrt(v̂) + eps) there after the step."""
    import inspect
    from repro_torch.core.bbit import unpack_codes_torch
    from repro_torch.data.hashed_dataset import _to_device, shard_row_counts
    from repro_torch.data.prefetch import StreamBatch, serial_batch_stream
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import ops
    from repro_torch.models.linear import _finish, bbit_logits_packed
    from repro_torch.optim.optimizers import AdamWConfig, make_optimizer
    from repro_torch.train import linear_trainer
    from repro_torch.train.losses import _per_example, mean_loss_with_preds_fn
    from repro_torch.train.metrics import trees_bitwise_equal
    from repro_torch.train.steps import (build_averaged_train_step,
                                         init_averaged_state)
    from repro_torch.train.streaming import fit_streaming

    opts = {name: p.default for name, p in
            inspect.signature(fit_streaming).parameters.items()
            if p.default is not inspect.Parameter.empty}
    opts.update(kw)
    if opts["optimizer"] != "adamw":
        fail(f"stream: the gap's witness reads AdamW's moments, not "
             f"{opts['optimizer']}'s")
    atol, rtol = STREAM_CPU_TOL["atol"], STREAM_CPU_TOL["rtol"]
    use, gap = {}, {}
    for name in sorted(u.params):
        a, c = u.params[name].cpu().double(), cpu.params[name].double()
        gap[name] = (a - c).abs()
        use[name] = float((gap[name] / (atol + rtol * c.abs())).max())
    leaf = max(gap, key=lambda name: float(gap[name].max()))
    at = np.unravel_index(int(gap[leaf].argmax()), tuple(gap[leaf].shape))
    at = tuple(int(i) for i in at)
    v = cpu.params["table"].shape[1]

    loss_fn = mean_loss_with_preds_fn(
        lambda p, x: bbit_logits_packed(p, x, cfg), opts["loss"],
        l2=opts["l2"])

    def loss_and_hits(p, x, y):
        total, pred = loss_fn(p, x, y)
        return total, torch.sum(pred == y)

    def grads(params, x, y):
        names = sorted(params)
        live = {n: params[n].detach().clone().requires_grad_(True)
                for n in names}
        loss, _ = loss_fn(live, x, y)
        return dict(zip(names, torch.autograd.grad(
            loss, [live[n] for n in names])))

    def dlogits(params, x, y):
        """The dout B6 gets: d mean loss / d B5's output."""
        with torch.no_grad():
            z = ops.bbit_linear_packed(x, params["table"], cfg.k, cfg.b)
        z.requires_grad_(True)
        per, _ = _per_example(_finish(z, params, cfg), y, opts["loss"])
        return torch.autograd.grad(torch.mean(per), z)[0].contiguous()

    host = torch.device("cpu")
    opt = make_optimizer(opts["optimizer"], opts["lr"])
    step = build_averaged_train_step(loss_and_hits, opt, has_aux=True)
    sides = {name: init_averaged_state(
        linear_trainer._initial_params(cfg, opts["seed"], side), opt)
        for name, side in (("card", dev), ("cpu", host))}
    acfg = AdamWConfig()
    batches = serial_batch_stream(
        root, opts["batch_size"], seed=opts["seed"], epochs=opts["epochs"],
        n_shards=len(shard_row_counts(root)), shuffle=opts["shuffle_shards"],
        start_epoch=0, start_pos=0, has_empty=False,
        transfer=lambda bp, bem, bl_: ((_to_device(bp, host),
                                        _to_device(bl_, host)), None))
    steps = []
    for ev in batches:
        if not isinstance(ev, StreamBatch):
            continue
        xh, yh = ev.args
        xc, yc = xh.to(dev), yh.to(dev)
        pc, ph = sides["card"].state.params, sides["cpu"].state.params
        gc = grads(pc, xc, yc)
        gh = grads(ph, xh, yh)
        gs = grads({n: t.cpu() for n, t in pc.items()}, xh, yh)
        dout = dlogits(pc, xc, yc)
        pc_before = {n: t.cpu().clone() for n, t in pc.items()}
        with torch.no_grad():
            dw = bl.bbit_linear_packed_bwd_dw(xc, dout, v, k=cfg.k,
                                              bits=cfg.b)
            dw_plain = bl.bbit_linear_packed_bwd_dw_plain(
                xc, dout, v, k=cfg.k, bits=cfg.b)
            if leaf == "table":
                hit = unpack_codes_torch(xc, cfg.k, cfg.b)[:, at[0]] == at[1]
                d = dout[hit, at[2]].double()
            else:
                d = dout[:, at[0]].double()
        sides["card"], _ = step(sides["card"], np.float32(0), xc, yc)
        sides["cpu"], _ = step(sides["cpu"], np.float32(0), xh, yh)
        t = len(steps) + 1
        rec = {
            "gap": max(float((sides["card"].state.params[n].cpu()
                              - sides["cpu"].state.params[n]).abs().max())
                       for n in pc),
            "grad_vs_plain": max(float((gc[n].cpu() - gs[n]).abs().max())
                                 for n in pc),
            "b6_vs_plain": float((dw - dw_plain).abs().max()),
            "b6_at": float(dw[at]) if leaf == "table" else None,
            "plain_at": float(dw_plain[at]) if leaf == "table" else None,
            "l2w": opts["l2"] * float(pc_before[leaf][at]),
            "rows": int(d.numel()), "dout_sum": float(d.sum()),
            "dout_abs_sum": float(d.abs().sum())}
        for side, g in (("card", gc), ("cpu", gh), ("plain_at_card", gs)):
            rec[f"g_{side}"] = float(g[leaf][at])
        for name in ("card", "cpu"):
            st = sides[name].state
            m = float(st.opt_state["m"][leaf][at])
            vv = float(st.opt_state["v"][leaf][at])
            rec[f"p_{name}"] = float(st.params[leaf][at])
            rec[f"adam_{name}"] = ((m / (1 - acfg.b1 ** t))
                                   / (math.sqrt(vv / (1 - acfg.b2 ** t))
                                      + acfg.eps))
        rec["cancel"] = (abs(rec["dout_sum"]) / rec["dout_abs_sum"]
                         if rec["dout_abs_sum"] else None)
        steps.append(rec)
    faithful = (trees_bitwise_equal(sides["card"].state.params, u.params)
                and trees_bitwise_equal(sides["cpu"].state.params,
                                        cpu.params))
    out = {"leaf": leaf, "at": at, "gap": float(gap[leaf][at]),
           "limit_use": use, "margin": 1.0 - max(use.values()),
           "replay_bitwise": faithful, "steps": steps}
    print(f"stream: card vs cpu gap at {leaf}{list(at)}: {out['gap']} (card "
          f"{float(u.params[leaf][at])}, cpu {float(cpu.params[leaf][at])});"
          f" share of the allclose limit used {use}, margin "
          f"{out['margin']}; the step replay ends on both fits' bits: "
          f"{faithful}")
    for t, rec in enumerate(steps, 1):
        print(f"stream: gap step {t}: {json.dumps(rec)}")
    if not faithful:
        fail("stream: the step replay departs from the fits it replays")
    return out


# the dp phase: the stream phase's oph archive at configs/rcv1_oph.py's
# streaming settings over 2 logical shard slots: 4 groups of 2 shards, 2
# steps a group (1,024 and 976 rows a slot), checkpoints every 4 shards;
# the gang's kill of rank 1 before step 5, after the checkpoint at shard
# 4; the elastic gang stopped after shard 4
DP_WORLD, DP_STEPS, DP_KILL_STEP, DP_STOP_SHARDS = 2, 8, 5, 4
DP_GANG_TIMEOUT_S = 300.0


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# a rounding flip the replay forgives: the two sides' inputs to the rounding
# within 1e-5 of the largest magnitude that rounding sees (an int8 block's
# absmax, 127 quanta; a bfloat16 tensor's largest value), the bound of a
# float32 sum taken in another order (DW_SUM_TOL); int8 results one quantum
# apart
FLIP_TOL = 1e-5


def split_int8(orig, g, block):
    """The compressed gradient's rounding (``_blockwise_quantize``): its
    int8 values, the input in quanta (each block over its own scale)."""
    import torch
    q, scale = orig(g, block)
    flat = torch.nn.functional.pad(
        g.reshape(-1), (0, (-g.numel()) % block)).reshape(-1, block)
    units = flat / scale[:, None]
    return (q, scale), q, units, lambda forced: (forced, scale)


def split_store(orig, x, dtype, block=0):
    """The optimizer's bfloat16 storage (``maybe_quantize``: the moments,
    a bfloat16 param's AdamW step); any other storage rounds nothing
    here."""
    out = orig(x, dtype, block)
    if dtype != "bfloat16":
        return out, None, None, None
    return out, out, x, lambda forced: forced


def split_dw(orig, *args, dtype=None, **kw):
    """B6's dW in a bfloat16 table's dtype (the wrapper on the card, its
    plain version on the CPU): the float32 sums, rounded here -- the
    bfloat16 kernel's output bit for bit, as bf16_kernels checks."""
    import torch
    wide = orig(*args, **kw)
    if dtype != torch.bfloat16:
        return wide, None, None, None
    out = wide.to(dtype)
    return out, out, wide, lambda forced: forced


def replay_hooks(which: str) -> list:
    """The roundings a replay records and forces, as (module, attr,
    split): ``int8`` the compressed gradient, ``moments`` AdamW's
    bfloat16 moments, ``bf16`` a bfloat16 table's two roundings a step
    (B6's dW and AdamW's store of the param).  Hooks that share a split
    share one record, in call order."""
    from repro_torch.distributed import grad_compression as gc
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.optim import optimizers as optmod
    return {"int8": [(gc, "_blockwise_quantize", split_int8)],
            "moments": [(optmod, "maybe_quantize", split_store)],
            "bf16": [(bl, "bbit_linear_packed_bwd_dw", split_dw),
                     (bl, "bbit_linear_packed_bwd_dw_plain", split_dw),
                     (optmod, "maybe_quantize", split_store)]}[which]


def rounding_replay(torch, hooks: list, card_fit, cpu_fit) -> dict:
    """The compressed gradient (int8), the bfloat16 moments and a
    bfloat16 table's dW and param round float32 state: where the card's
    and the CPU's inputs straddle a rounding boundary by a float32
    rounding, they take neighbouring values a whole quantum apart, and
    the fits part by far more than their float32 sums do.  So: the card
    fit again with ``hooks`` (``replay_hooks``) recording each rounding;
    then the CPU fit, each rounding taking the card's result wherever the
    two differ -- each such flip checked to be a boundary one (inputs
    within FLIP_TOL of the largest magnitude the rounding sees, int8
    results one quantum apart) -- and every other operation its own.
    → the flips and the CPU replay's fit (the card's recorded fit must
    equal ``card_fit`` bit for bit)."""
    import functools
    from repro_torch.train.metrics import trees_bitwise_equal

    record = {split: [] for _, _, split in hooks}
    at = dict.fromkeys(record, 0)
    flips = {"calls": 0, "flips": 0, "bad": 0, "worst": 0.0}

    def recording(orig, split):
        def call(*args, **kw):
            out, got, units, _ = split(orig, *args, **kw)
            if got is not None:
                record[split].append((got.detach().cpu().clone(),
                                      units.detach().cpu().clone()))
            return out
        return call

    def forcing(orig, split):
        def call(*args, **kw):
            out, got, units, put = split(orig, *args, **kw)
            if got is None:
                return out
            want, want_units = record[split][at[split]]
            at[split] += 1
            flips["calls"] += 1
            diff = got != want
            if got.is_floating_point():
                gap = (units - want_units).abs() / want_units.abs().max(
                ).clamp_min(1e-30)
                ok = gap[diff] <= FLIP_TOL
            else:
                # the inputs in quanta: an int8 block's absmax is 127
                gap = (units - want_units).abs() / 127.0
                step = (got.to(torch.int32) - want.to(torch.int32)).abs()
                ok = (step[diff] == 1) & (gap[diff] <= FLIP_TOL)
            n = int(diff.sum())
            if n:
                flips["flips"] += n
                flips["bad"] += int((~ok).sum())
                flips["worst"] = max(flips["worst"], float(gap[diff].max()))
            return put(torch.where(diff, want, got))
        return call

    origs = {(mod, attr): getattr(mod, attr) for mod, attr, _ in hooks}

    def patch(wrap):
        # a kernel wrapper counts its launches on itself: keep its counters
        for mod, attr, split in hooks:
            orig = origs[(mod, attr)]
            setattr(mod, attr, functools.wraps(orig)(wrap(orig, split)))

    try:
        patch(recording)
        again = card_fit["fit"]()
        patch(forcing)
        cpu_replay = cpu_fit()
    finally:
        for (mod, attr), orig in origs.items():
            setattr(mod, attr, orig)
    same = (trees_bitwise_equal(again.params, card_fit["res"].params)
            and trees_bitwise_equal(again.avg_params,
                                    card_fit["res"].avg_params))
    return dict(flips, recorded=sum(map(len, record.values())),
                card_repeats=same, replay=cpu_replay)


def phase_dp(torch, dev, card: str, data: dict, handover: dict) -> dict:
    """The paper's data-parallel streaming path on the stream phase's oph
    archive: fit_streaming folding 2 logical slots in one process, a
    2-rank gang (both ranks on the card, over gloo) killed once, an
    elastic 2 -> 1 resume, the compressed exchanges and the narrow AdamW
    moments against the CPU, and the fold's step through a one-rank NCCL
    group."""
    return dp_in(torch, dev, card, data, handover["oph_root"],
                 os.path.join(handover["stream_work"], "dp"))


def gang_matches(path: str, res) -> bool:
    """A gang rank's dumped params and average bit for bit ``res``'s."""
    from repro_torch import tree
    got = np.load(path)
    want = {f"p{i}": t for i, t in enumerate(tree.leaves(res.params))}
    want.update({f"a{i}": t for i, t
                 in enumerate(tree.leaves(res.avg_params))})
    return set(got.files) == set(want) and all(
        np.array_equal(got[k], t.cpu().numpy()) for k, t in want.items())


def dp_in(torch, dev, card: str, data: dict, root: str, work: str) -> dict:
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import preprocess_rows_packed
    from repro_torch.distributed import collectives
    from repro_torch.distributed.runtime import (init_runtime,
                                                 shutdown_runtime)
    from repro_torch.ft.faults import FaultEvent, FaultPlan
    from repro_torch.ft.retry import BackoffPolicy
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.kernels import ops
    from repro_torch.models.linear import bbit_scores_packed
    from repro_torch.train.metrics import accuracy, trees_bitwise_equal
    from repro_torch.train.streaming import fit_streaming
    from repro_torch.train.supervisor import (RestartPolicy,
                                              run_multiprocess_supervised)

    rows, labels = data["rows"], data["labels"]
    n = TRAIN_ROWS
    cfg = CONFIG.linear_config()
    kw = CONFIG.stream_kwargs(seed=CONFIG.seed, data_parallel=DP_WORLD,
                              elastic=True)
    serial_kw = dict(kw, data_parallel=None)
    policy = RestartPolicy(max_restarts=2, backoff=BackoffPolicy(
        base_s=0.05, cap_s=0.5, seed=CONFIG.seed))
    out = {"card": card, "settings": dict(
        kw, kill_step=DP_KILL_STEP, stop_after_shards=DP_STOP_SHARDS)}

    def fit(**extra):
        return fit_streaming(root, cfg, device=dev, **dict(kw, **extra))

    def gang(name, **extra):
        return timed(torch, lambda: run_multiprocess_supervised(
            root, cfg, procs=2, run_dir=os.path.join(work, name),
            policy=policy, local_devices=1,
            attempt_timeout_s=DP_GANG_TIMEOUT_S,
            ckpt_dir=os.path.join(work, name, "ckpt"), device="cuda",
            **dict(kw, **extra)))

    def wire(res) -> dict:
        cb = collectives.collective_bytes()
        return {op: cb[op] / res.n_steps for op in ("all-reduce",
                                                    "all-gather")}

    # -- the main path on the card: every launch counted from here ----
    ops.reset_counts()
    runs, backends, wires = {}, {}, {}
    steps_wd = StepWatchdog(window=DP_STEPS)
    collectives.reset_collective_stats()
    runs["fold"] = fit(ckpt_dir=os.path.join(work, "fold"),
                       watchdog=steps_wd)
    backends["fold"] = "none (one process, no group)"
    wires["exact"] = wire(runs["fold"])
    kill = FaultPlan([FaultEvent(site="proc_kill", step=DP_KILL_STEP,
                                 rank=1, times=1)])
    g, g_s = gang("gang", fault_spec=kill.to_spec())
    part, part_s = gang("elastic", stop_after_shards=DP_STOP_SHARDS)
    runs["elastic"] = fit(ckpt_dir=os.path.join(work, "elastic", "ckpt"))
    backends["elastic"] = "gloo gang, then none"
    for bits in (8, 1):
        collectives.reset_collective_stats()
        runs[f"compress{bits}"] = fit(grad_compress=bits)
        backends[f"compress{bits}"] = backends["fold"]
        wires[f"compress{bits}"] = wire(runs[f"compress{bits}"])
    for md in ("bfloat16", "int8"):
        runs[f"adamw_{md}"] = fit_streaming(root, cfg, device=dev,
                                            moment_dtype=md, **serial_kw)
        backends[f"adamw_{md}"] = "none (serial arm)"
    rt = init_runtime(procs=1, rank=0,
                      coordinator=f"127.0.0.1:{free_port()}", device=dev,
                      backend="nccl")
    try:
        collectives.reset_collective_stats()
        runs["nccl"] = fit(runtime=rt)
        nccl_stats = collectives.collective_stats()
        backends["nccl"] = rt.backend
    finally:
        shutdown_runtime()
    held, _ = preprocess_rows_packed(rows[n:], K, B, scheme="oph",
                                     seed=HASH_SEED, device=dev)
    held_t = torch.from_numpy(held).to(dev)
    accs = {}
    with torch.no_grad():
        for name, res in runs.items():
            accs[name] = accuracy(
                bbit_scores_packed(res.eval_params, held_t, cfg) > 0,
                labels[n:])
    torch.cuda.synchronize()
    counts = ops.counts()
    # -- end of the main path -------------------------------------------

    fold = runs["fold"]
    for name, res in runs.items():
        line = dict(fit_line(res), backend=backends[name],
                    test_acc=accs[name], lineage=res.topology_lineage)
        if name == "elastic":
            # this call trained the half after the gang's 4 shards
            line["rows"] = res.examples_seen - part.result["examples_seen"]
            line["rows_per_s"] = line["rows"] / res.train_seconds
        out[name] = line
        print(f"dp: fit {name} backend={line['backend']} seconds="
              f"{line['seconds']} steps={line['steps']} rows="
              f"{line['rows']} rows_per_s={line['rows_per_s']} "
              f"progressive_acc={line['progressive_acc']} held-out "
              f"accuracy={accs[name]} lineage={res.topology_lineage} "
              f"card={card}")
        if accs[name] <= 0.9:
            fail(f"dp: {name} held-out accuracy {accs[name]} <= 0.9")
    if (fold.n_steps, fold.examples_seen) != (DP_STEPS, n):
        fail(f"dp: fold took {fold.n_steps} steps over "
             f"{fold.examples_seen} rows")
    step_ms = [t * 1e3 for t in steps_wd.window]
    out["fold"].update(step_ms_median=float(np.median(step_ms)),
                       step_ms_max=max(step_ms))
    print(f"dp: fold's steps on the host (enqueue, StepWatchdog, 2 slots "
          f"a step): median {out['fold']['step_ms_median']} ms, max "
          f"{out['fold']['step_ms_max']} ms card={card}")
    for name, res in (("elastic", runs["elastic"]), ("nccl", runs["nccl"])):
        same = (trees_bitwise_equal(fold.params, res.params)
                and trees_bitwise_equal(fold.avg_params, res.avg_params)
                and fold.progressive_acc == res.progressive_acc)
        print(f"dp: {name} fit bitwise equal to the fold (params, "
              f"average, progressive accuracy)={same}")
        if not same:
            fail(f"dp: the {name} fit departs from the fold")
    if [r["procs"] for r in runs["elastic"].topology_lineage] != [2, 1]:
        fail(f"dp: elastic lineage {runs['elastic'].topology_lineage}")
    n_all_reduce = sum(st["op"] == "all-reduce" for st in nccl_stats)
    print(f"dp: the fold's steps through a one-rank NCCL group: "
          f"{n_all_reduce} all-reduces over {runs['nccl'].n_steps} steps "
          f"(group size {sorted({st['group_size'] for st in nccl_stats})})")
    if n_all_reduce != 2 * runs["nccl"].n_steps:
        fail("dp: the NCCL run did not issue two all-reduces a step")

    # -- the gangs (worker processes: their own launch counters) --------
    out["gang"] = dict(restarts=g.restarts, wall_s=g_s,
                       attempt_s=g.attempt_s,
                       crashes=[c.error for c in g.crashes],
                       backoff_s=[c.backoff_s for c in g.crashes],
                       recover_s=[c.recover_s for c in g.crashes],
                       results=g.results)
    out["elastic"]["gang"] = dict(wall_s=part_s, attempt_s=part.attempt_s,
                                  result=part.result)
    print(f"dp: gang of 2 ranks on {[r['device'] for r in g.results.values()]}"
          f" over {[r['backend'] for r in g.results.values()]}: restarts="
          f"{g.restarts} ({out['gang']['crashes']}), attempt seconds "
          f"{g.attempt_s}, backoff {out['gang']['backoff_s']} s, recovery "
          f"{out['gang']['recover_s']} s, run_multiprocess_supervised "
          f"{g_s} s in all; the elastic gang stopped after "
          f"{part.result['shards_processed']} shards in {part.attempt_s} s "
          f"card={card}")
    if g.restarts != 1 or "signal 9" not in g.crashes[0].error:
        fail(f"dp: {g.restarts} gang restarts for one kill")
    if part.result["completed"] or part.result["shards_processed"] != \
            DP_STOP_SHARDS:
        fail(f"dp: the elastic gang stopped at {part.result}")
    for r, rec in g.results.items():
        same = gang_matches(g.params_paths[r], fold)
        gc = rec["kernel_counts"]
        stray = {k: v for k, v in gc.items() if k.endswith("_plain") and v}
        # the worker's counters and record cover its last attempt: the
        # steps after the resume, two all-reduces each
        print(f"dp: gang rank {r} backend={rec['backend']} device="
              f"{rec['device']} params and average bitwise equal to the "
              f"fold={same}; its last attempt: "
              f"{rec['collectives']['count'] // 2} steps in "
              f"{rec['train_seconds']} s, launches B5 "
              f"{gc['bbit_linear_packed_fwd']} B6 "
              f"{gc['bbit_linear_packed_bwd_dw']}, plain {stray}, wire "
              f"bytes {rec['collectives']}")
        if not same:
            fail(f"dp: gang rank {r} departs from the fold")
        if rec["backend"] != "gloo":
            fail(f"dp: gang rank {r} ran over {rec['backend']}")
        if stray or not (gc["bbit_linear_packed_fwd"]
                         and gc["bbit_linear_packed_bwd_dw"]):
            fail(f"dp: gang rank {r} launches {gc}")
    # the elastic gang ran from step 0: its record is its whole fit
    prec = part.result
    out["elastic"]["gang"]["rows_per_s"] = (prec["examples_seen"]
                                            / prec["train_seconds"])
    print(f"dp: the elastic gang (rank 0, from step 0 over gloo): "
          f"{prec['n_steps']} steps, {prec['examples_seen']} rows in "
          f"{prec['train_seconds']} s, "
          f"{out['elastic']['gang']['rows_per_s']} rows/s card={card}")
    wires["gang_exact"] = {op: prec["collectives"][op] / prec["n_steps"]
                           for op in ("all-reduce", "all-gather")}
    out["wire_bytes_per_step"] = wires
    print(f"dp: wire bytes a step (the result landing on each "
          f"participant; in one process the group has one member) "
          f"{json.dumps(wires)}")
    if not (wires["compress8"]["all-gather"]
            < wires["exact"]["all-reduce"] / 3
            and wires["compress1"]["all-gather"]
            < wires["compress8"]["all-gather"]):
        fail(f"dp: compressed wire bytes {wires}")

    need = ("oph_pack", "bbit_linear_packed_fwd",
            "bbit_linear_packed_bwd_dw")
    missing = [name for name in need if counts[name] < 1]
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    print(f"dp: launches {json.dumps(counts)}")
    if missing or stray:
        fail(f"dp: kernels not launched {missing}, plain calls {stray}")
    out["counts"] = counts

    # -- the same fits on the CPU (the kernels' plain versions) ---------
    def compare(res, cpu):
        errs, outside = {}, {}
        for tag, a, b_ in (("params", res.params, cpu.params),
                           ("avg", res.avg_params, cpu.avg_params)):
            for key in a:
                errs[f"{tag}.{key}"] = float(
                    (a[key].cpu() - b_[key]).abs().max())
                outside[f"{tag}.{key}"] = int((~torch.isclose(
                    a[key].cpu(), b_[key], **STREAM_CPU_TOL)).sum())
        return errs, outside, not any(outside.values())

    for name, extra in (("compress8", dict(grad_compress=8)),
                        ("compress1", dict(grad_compress=1)),
                        ("adamw_bfloat16", dict(serial_kw,
                                                moment_dtype="bfloat16")),
                        ("adamw_int8", dict(serial_kw,
                                            moment_dtype="int8"))):
        opts = dict(kw, **extra)
        cpu = fit_streaming(root, cfg, device="cpu", **opts)
        res = runs[name]
        errs, outside, close = compare(res, cpu)
        out[name]["cpu"] = dict(fit_line(cpu), max_abs_err=errs,
                                outside=outside, allclose=close)
        print(f"dp: {name} card vs cpu: steps {res.n_steps}/{cpu.n_steps} "
              f"progressive_acc {res.progressive_acc}/{cpu.progressive_acc}"
              f" max_abs_err {errs} allclose(rtol 1e-4, atol 1e-5)="
              f"{close} (elements outside {outside}); {cpu.train_seconds} "
              "s on the host")
        if (res.n_steps, res.examples_seen) != (cpu.n_steps,
                                                cpu.examples_seen):
            fail(f"dp: the card's {name} fit departs from the CPU's")
        if close:
            continue
        if name not in ("compress8", "adamw_bfloat16"):
            fail(f"dp: the card's {name} fit departs from the CPU's")
        # a path that rounds its state: replay the CPU fit with the card's
        # rounding decisions, each one a checked boundary flip
        rep = rounding_replay(
            torch, replay_hooks("int8" if name.startswith("compress")
                                else "moments"),
            {"res": res,
             "fit": lambda: fit_streaming(root, cfg, device=dev, **opts)},
            lambda: fit_streaming(root, cfg, device="cpu", **opts))
        r_errs, r_outside, r_close = compare(res, rep["replay"])
        out[name]["cpu"]["replay"] = dict(
            {k: rep[k] for k in ("calls", "recorded", "flips", "bad",
                                 "worst", "card_repeats")},
            max_abs_err=r_errs, outside=r_outside, allclose=r_close)
        print(f"dp: {name} replayed on the cpu with the card's rounding: "
              f"{rep['flips']} flips over {rep['calls']} roundings "
              f"({rep['bad']} beyond {FLIP_TOL} of the largest input; "
              f"widest input gap {rep['worst']} of it), the card fit "
              f"repeated bitwise="
              f"{rep['card_repeats']}; then max_abs_err {r_errs} "
              f"allclose(rtol 1e-4, atol 1e-5)={r_close} (elements outside "
              f"{r_outside})")
        if (rep["bad"] or not rep["card_repeats"] or not r_close
                or rep["calls"] != rep["recorded"]):
            fail(f"dp: the card's {name} fit departs from the CPU's beyond "
                 "its rounding flips")
    return out


def serve_plan(n_docs: int, rng):
    """Requests over ``n_docs`` held-out documents: each once, plus
    repeats making SERVE_REPEAT_FRAC of all sent, shuffled and cut into
    requests of 1..SERVE_MAX_REQUEST documents → list of index arrays."""
    n_rep = int(round(n_docs * SERVE_REPEAT_FRAC / (1 - SERVE_REPEAT_FRAC)))
    order = np.concatenate([np.arange(n_docs),
                            rng.integers(0, n_docs, size=n_rep)])
    rng.shuffle(order)
    reqs, lo = [], 0
    while lo < len(order):
        size = int(rng.integers(1, SERVE_MAX_REQUEST + 1))
        reqs.append(order[lo: lo + size])
        lo += size
    return reqs


def score_bodies(docs, reqs):
    """Each request's JSON body, encoded before any request is timed."""
    return [json.dumps({"docs": [docs[i].tolist() for i in r]}).encode()
            for r in reqs]


def post_json(client, path: str, body: bytes):
    """→ (status, headers, parsed body) of one POST."""
    resp = client.request("POST", path, body)
    return resp.status, dict(resp.getheaders()), json.loads(resp.read())


def drive(port: int, bodies, on_answer=None):
    """SERVE_CLIENTS threads POST /score the bodies (thread t takes
    bodies t, t + SERVE_CLIENTS, ...), each over one keep-alive
    connection → ([(version, float32 scores, latency s)] by body, wall
    s).  Any status but 200 fails."""
    import threading
    from repro_torch.serving import ScoreClient
    results, errors = [None] * len(bodies), []

    def client(t):
        c = ScoreClient("127.0.0.1", port, timeout=SERVE_WAIT_S)
        try:
            for j in range(t, len(bodies), SERVE_CLIENTS):
                t0 = time.perf_counter()
                status, _, obj = post_json(c, "/score", bodies[j])
                lat = time.perf_counter() - t0
                if status != 200:
                    raise RuntimeError(f"/score answered {status}: {obj}")
                results[j] = (obj["version"],
                              np.asarray(obj["scores"], np.float32), lat)
                if on_answer is not None:
                    on_answer()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_WAIT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"serve: clients failed: {errors[:3]}")
    return results, wall


def check_answers(name: str, reqs, results, pinned: dict) -> set:
    """Every answer holds one version, and its scores equal score_docs
    pinned to that version's WeightSet bit for bit → versions seen."""
    seen = set()
    for req, (version, scores, _) in zip(reqs, results):
        if version not in pinned:
            fail(f"serve: {name}: unknown version {version!r}")
        seen.add(version)
        if not np.array_equal(scores, pinned[version][req]):
            fail(f"serve: {name}: scores of version {version} differ from "
                 f"score_docs pinned to it: max_abs_err "
                 f"{float(np.abs(scores - pinned[version][req]).max())}")
    return seen


def pinned_scores(eng, docs, weights) -> np.ndarray:
    """score_docs pinned to ``weights``, ROWS documents a call."""
    return np.concatenate([eng.score_docs(docs[lo: lo + ROWS],
                                          weights=weights)
                           for lo in range(0, len(docs), ROWS)])


def host_scores(scheme, docs, params: dict) -> np.ndarray:
    """numpy_scores (the host encode and a float64 gather-sum) in chunks
    of 512 documents."""
    return np.concatenate([
        numpy_scores(scheme, docs[lo: lo + 512], params["table"],
                     params["bias"])[0]
        for lo in range(0, len(docs), 512)])


def latency_ms(results) -> dict:
    lat = np.array([r[2] for r in results]) * 1e3
    return {f"p{q}_ms": float(np.percentile(lat, q)) for q in (50, 95, 99)}


def phase_serve(torch, dev, card: str, data: dict, handover: dict) -> dict:
    """configs/rcv1_oph.py's serving deployment (serve_kwargs +
    dedup_kwargs) behind a ScoreServer on an ephemeral port, with the
    stream phase's published params; SERVE_DIR is removed after."""
    import shutil
    try:
        return serve_in(torch, dev, card, data, handover)
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)


def serve_in(torch, dev, card: str, data: dict, handover: dict) -> dict:
    import threading
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import ops
    from repro_torch.serving import (AdmissionController,
                                     HashedClassifierEngine, HTTPStatusError,
                                     ScoreClient, ScoreServer,
                                     load_serving_params)
    from repro_torch.train.metrics import accuracy

    cfg = CONFIG.linear_config()
    kw = dict(CONFIG.serve_kwargs(), **CONFIG.dedup_kwargs())
    want_kw = dict(scheme="oph", max_batch=ROWS, max_wait_ms=2.0,
                   nnz_buckets=(128, 512, 2048, 8192, 32768),
                   pipeline_depth=2, dedup_cache=True, dedup_entries=65536,
                   dedup_rows_per_band=4, dedup_probe_bands=4)
    if ((cfg.k, cfg.b) != (K, B)
            or any(kw[key] != v for key, v in want_kw.items())):
        fail(f"serve: configs/rcv1_oph.py's serving settings are not "
             f"k={K}, b={B}, {want_kw}: {kw}")
    held = data["rows"][TRAIN_ROWS:]
    labels = data["labels"][TRAIN_ROWS:]
    ckpt_dir = handover["ckpt_dir"]
    first, last = CONFIG.ckpt_every_shards, STREAM_SHARDS
    if ckpt.latest_published(ckpt_dir) != last:
        fail(f"serve: latest published step "
             f"{ckpt.latest_published(ckpt_dir)}, not {last}")
    template = {name: np.zeros_like(v)
                for name, v in handover["eval_params"].items()}
    params_first, step = load_serving_params(ckpt_dir, template, first)
    params_last, _ = load_serving_params(ckpt_dir, template)
    if not all(np.array_equal(params_last[n], handover["eval_params"][n])
               for n in template):
        fail("serve: the last published params are not the stream fit's "
             "eval params")
    out = {"card": card, "settings": {k: (list(v) if isinstance(v, tuple)
                                          else v) for k, v in kw.items()},
           "docs": len(held), "clients": SERVE_CLIENTS}
    nnz_all = np.array([len(d) for d in held])
    eng = HashedClassifierEngine(params_first, cfg, seed=HASH_SEED,
                                 device=dev, version=f"ckpt-{step}", **kw)
    out["precompile_s"] = eng.precompile_seconds
    w_first = eng.current_weights()

    # -- checks before the server: the dedup keys' bytes against B2, and
    # B5's bits at row buckets 1 and 64 -------------------------------
    keys = eng._dedup_keys(held)
    b2_equal = True
    for lo in range(0, len(held), ROWS):
        idx, nnz = pad_rows(held[lo: lo + ROWS], pad_to_multiple=1)
        lane = eng._nnz_bucket(idx.shape[1])       # the engine's pad width
        idx = np.pad(idx, ((0, 0), (0, lane - idx.shape[1])))
        packed, empty = eng.scheme.encode_packed(
            torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev), B)
        packed = packed.cpu().numpy()
        b2_equal &= empty is None and all(
            packed[i].tobytes() == keys[lo + i][1] and keys[lo + i][2] is None
            for i in range(len(packed)))
    print(f"serve: host encode (dedup keys) vs B2 over {len(held)} held-out "
          f"docs (nnz {nnz_all.min()}..{nnz_all.max()}): bytes "
          f"equal={b2_equal}")
    if not b2_equal:
        fail("serve: the dedup keys' bytes differ from B2's")
    lane = eng._nnz_bucket(len(held[0]))
    mates = [d for d in held if eng._nnz_bucket(len(d)) == lane][:ROWS]
    one = eng.score_docs(mates[:1])
    full = eng.score_docs(mates)
    print(f"serve: one doc at row bucket 1 and 64 (lane {lane}, "
          f"{len(mates)} docs): bitwise equal={one[0] == full[0]}")
    if len(mates) != ROWS or one[0] != full[0]:
        fail("serve: B5's bits depend on the row bucket")

    # -- the main path: every launch counted from here ------------------
    rng = np.random.default_rng(0)
    reqs = serve_plan(len(held), rng)
    bodies = score_bodies(held, reqs)
    n_sent = sum(len(r) for r in reqs)
    # the same requests in-process (submit_many, no HTTP) from this
    # thread, the cache emptied after
    t0 = time.perf_counter()
    futs = [f for r in reqs for f in eng.submit_many([held[i] for i in r])]
    for f in futs:
        f.result(timeout=SERVE_WAIT_S)
    inproc_s = time.perf_counter() - t0
    eng.dedup.invalidate(eng.version)
    out["in_process"] = dict(seconds=inproc_s, docs_per_s=n_sent / inproc_s)
    print(f"serve: the steady pass's requests in-process (submit_many, one "
          f"thread, no HTTP): {inproc_s} s, {n_sent / inproc_s} docs/s "
          f"card={card}")
    srv = ScoreServer(eng, **CONFIG.http_kwargs(port=0))
    ops.reset_counts()
    srv.start_in_thread(timeout=SERVE_WAIT_S)
    client = ScoreClient("127.0.0.1", srv.port, timeout=SERVE_WAIT_S)
    dd0, runs0 = eng.dedup.stats(), eng.batcher.batches_run
    steady, wall = drive(srv.port, bodies)
    dd1, batches = eng.dedup.stats(), eng.batcher.batches_run - runs0
    eng_lat = {key: eng.stats()[key] for key in ("p50_ms", "p95_ms",
                                                 "p99_ms")}
    hits = dd1["hits"] - dd0["hits"]
    lookups = hits + dd1["misses"] - dd0["misses"]
    eng.dedup.invalidate(eng.version)
    (prof_res, _), prof = profiled(torch, lambda: drive(srv.port, bodies))
    # a dedup hit against a fresh score: every doc of one full batch,
    # cached now, again through submit_many
    hit_docs = mates
    hits_before = eng.dedup.stats()["hits"]
    futs = eng.submit_many(hit_docs)
    hit_scores = np.asarray([f.result(timeout=SERVE_WAIT_S)
                             for f in futs], np.float32)
    hits_now = eng.dedup.stats()["hits"] - hits_before
    nd_docs = held[:ROWS]
    nd = client.score_ndjson(nd_docs)

    # reload mid-traffic, to the last published step
    answered, lock, due = [0], threading.Lock(), threading.Event()
    reload_reqs = serve_plan(len(held), np.random.default_rng(1))

    def on_answer():
        with lock:
            answered[0] += 1
            if answered[0] == len(reload_reqs) // 3:
                due.set()

    reload_info = {}

    def reloader():
        if due.wait(SERVE_WAIT_S):
            c = ScoreClient("127.0.0.1", srv.port, timeout=SERVE_WAIT_S)
            reload_info.update(c.reload(ckpt_dir))
            c.close()

    ctl = threading.Thread(target=reloader)
    ctl.start()
    mixed, mixed_wall = drive(srv.port, score_bodies(held, reload_reqs),
                              on_answer)
    ctl.join(timeout=SERVE_WAIT_S)
    w_last = eng.current_weights()
    bad_reload = {}
    for what in ("empty_dir", "state_dir"):
        try:
            client.reload(handover[what])
            bad_reload[what] = 200
        except HTTPStatusError as e:
            bad_reload[what] = e.status
    version_after = eng.version
    # held-out accuracy of the served scores at the last step
    acc_reqs = [np.arange(lo, min(lo + ROWS, len(held)))
                for lo in range(0, len(held), ROWS)]
    acc_res, acc_wall = drive(srv.port, score_bodies(held, acc_reqs))
    # admission: one request past the budget
    budget = AdmissionController.for_engine(eng).limit
    status, headers, _ = post_json(client, "/score", json.dumps(
        {"docs": [[1, 2, 3]] * (budget + 1)}).encode())
    retry_after = headers.get("Retry-After")
    client.close()
    # drain under load, the cache emptied so the load reaches the card
    eng.dedup.invalidate(eng.version)
    drained, drain_errors, stop = [], [], threading.Event()

    def hammer(t):
        c = ScoreClient("127.0.0.1", srv.port, timeout=SERVE_WAIT_S)
        lo = t * 16
        while not stop.is_set():
            sent = [held[(lo + i) % len(held)] for i in range(16)]
            lo += SERVE_CLIENTS * 16
            try:
                r = c.score(sent)
                drained.append(len(r["scores"]) == len(sent))
            except HTTPStatusError as e:
                if e.status != 503:
                    drain_errors.append(repr(e))
                break
            except OSError:          # the socket closed after the drain
                break
        c.close()

    hammers = [threading.Thread(target=hammer, args=(t,))
               for t in range(SERVE_CLIENTS)]
    for t in hammers:
        t.start()
    time.sleep(0.3)
    srv.request_drain()
    finished = srv.wait_finished(timeout=SERVE_WAIT_S)
    stop.set()
    for t in hammers:
        t.join(timeout=SERVE_WAIT_S)
    torch.cuda.synchronize()
    counts = ops.counts()
    # -- end of the main path -------------------------------------------

    inflight = srv.admission.snapshot()["inflight"]
    print(f"serve: drain under load: {len(drained)} answers, all complete="
          f"{all(drained)}, errors {drain_errors}, wait_finished={finished}"
          f", drained_clean={srv.drained_clean}, in flight after {inflight}")
    if (not finished or srv.drained_clean is not True or drain_errors
            or not drained or not all(drained) or inflight
            or any(t.is_alive() for t in hammers)):
        fail("serve: the drain dropped or failed requests")
    need = ("oph_pack", "bbit_linear_packed_fwd")
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    print(f"serve: launches {json.dumps(counts)}")
    if any(counts[name] < 1 for name in need) or stray:
        fail(f"serve: kernels {need} not launched or plain calls {stray}")
    out["counts"] = {name: counts[name] for name in KERNELS}

    # the answers against score_docs pinned to each version, the host
    # reference, the dedup hit and the stream fit's accuracy
    pinned = {w_first.version: pinned_scores(eng, held, w_first),
              w_last.version: pinned_scores(eng, held, w_last)}
    if w_last.version != f"ckpt-{last}":
        fail(f"serve: live version {w_last.version} after the reload")
    for name, rq, res in (("steady", reqs, steady),
                          ("profiled", reqs, prof_res),
                          ("accuracy", acc_reqs, acc_res)):
        check_answers(name, rq, res, pinned)
    seen = check_answers("reload", reload_reqs, mixed, pinned)
    print(f"serve: reload mid-traffic {json.dumps(reload_info)}: versions "
          f"seen {sorted(seen)}, every answer equal to score_docs pinned to "
          f"its version; empty dir -> {bad_reload['empty_dir']}, training "
          f"state -> {bad_reload['state_dir']}, live version "
          f"{version_after}")
    if (seen != {w_first.version, w_last.version}
            or reload_info.get("version") != w_last.version
            or bad_reload != {"empty_dir": 404, "state_dir": 409}
            or version_after != w_last.version):
        fail("serve: the reload was not version-exact or a bad reload "
             "changed the live version")
    host = {v: host_scores(eng.scheme, held, p) for v, p in
            ((w_first.version, params_first), (w_last.version, params_last))}
    err_host = max(float(np.abs(pinned[v] - host[v]).max()) for v in host)
    if not all(np.allclose(pinned[v], host[v], **TOL) for v in host):
        fail(f"serve: served scores vs the host reference {err_host}")
    fresh_one = np.concatenate([eng.score_docs([d], weights=w_first)
                                for d in hit_docs[:8]])
    hit_equal = (hits_now == len(hit_docs)
                 and np.array_equal(hit_scores, pinned_scores(
                     eng, hit_docs, w_first))
                 and np.array_equal(hit_scores[:8], fresh_one))
    print(f"serve: {hits_now} dedup hits of {len(hit_docs)} cached docs "
          f"equal fresh scores at row buckets 64 and 1={hit_equal}")
    if not hit_equal:
        fail("serve: a dedup hit differs from a fresh score")
    nd_ok = ([ln["i"] for ln in nd] == list(range(len(nd_docs)))
             and all(ln["version"] == w_first.version for ln in nd)
             and np.array_equal(np.asarray([ln["score"] for ln in nd],
                                           np.float32),
                                pinned[w_first.version][:len(nd_docs)]))
    print(f"serve: /score_ndjson {len(nd)} lines in order, each with its "
          f"version, equal to the pinned scores={nd_ok}")
    if not nd_ok:
        fail("serve: /score_ndjson out of order or off its version")
    served_last = np.concatenate([r[1] for r in acc_res])
    acc = accuracy(served_last > 0, labels)
    out["test_acc"] = {"served": acc, "stream": handover["test_acc"]}
    print(f"serve: held-out accuracy of the served scores at "
          f"{w_last.version}: {acc} (stream phase {handover['test_acc']})")
    if abs(acc - handover["test_acc"]) > SERVE_ACC_TOL:
        fail("serve: held-out accuracy departs from the stream phase's")
    print(f"serve: admission budget {budget} rows (for_engine): a request "
          f"of {budget + 1} docs -> {status}, Retry-After {retry_after}")
    if status != 429 or not retry_after or float(retry_after) <= 0:
        fail("serve: no 429 with Retry-After past the admission budget")

    # the steady pass's host work, one step at a time on this thread: the
    # server's parse, the dedup keys' host encode, the engine's padding
    t0 = time.perf_counter()
    parsed = [srv._parse_docs(body) for body in bodies]
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for docs in parsed:
        eng._dedup_keys(docs)
    keys_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for docs in parsed:
        pad_rows(docs, pad_to_multiple=1)
    pad_s = time.perf_counter() - t0
    out["host_s"] = dict(parse=parse_s, dedup_keys=keys_s, padding=pad_s)
    print(f"serve: the steady pass's host work, serially on one thread: "
          f"parse (json + numpy) {parse_s} s, dedup keys (host encode + "
          f"band keys) {keys_s} s, padding of every document {pad_s} s, "
          f"against the pass's {wall} s card={card}")
    lat = latency_ms(steady)
    out["steady"] = dict(requests=len(reqs), docs=n_sent, seconds=wall,
                         batches=batches,
                         requests_per_s=len(reqs) / wall,
                         docs_per_s=n_sent / wall, client=lat,
                         engine=eng_lat,
                         dedup_hit_rate=hits / lookups if lookups else 0.0)
    st = out["steady"]
    print(f"serve: steady pass {len(reqs)} requests ({n_sent} docs, "
          f"{SERVE_CLIENTS} clients, 1-{SERVE_MAX_REQUEST} docs a request) "
          f"in {wall} s: {st['requests_per_s']} requests/s "
          f"{st['docs_per_s']} docs/s; client latency p50/p95/p99 "
          f"{lat['p50_ms']}/{lat['p95_ms']}/{lat['p99_ms']} ms; engine "
          f"stats() p50/p95/p99 {eng_lat['p50_ms']}/{eng_lat['p95_ms']}/"
          f"{eng_lat['p99_ms']} ms; dedup hit rate {st['dedup_hit_rate']} "
          f"({hits} of {lookups}); {batches} micro-batches for the "
          f"{lookups - hits} misses card={card}")
    if prof["device_ms"] > 0:
        prof["busy_share"] = prof["device_ms"] / (wall * 1e3)
        busy = (f"device busy {prof['device_ms']} ms in a profiled pass of "
                f"{prof['wall_ms']} ms, share of the unprofiled pass "
                f"({wall * 1e3} ms) {prof['busy_share']}; top {prof['top']}"
                f"; host top (self ms, calls) {prof['host_top']}")
    else:
        busy = "device busy: not measured (no device time traced)"
    out["profile"] = prof
    print(f"serve: profile of the steady pass (cache emptied first): {busy} "
          f"card={card}")
    out["reload_pass"] = dict(seconds=mixed_wall, info=reload_info,
                              client=latency_ms(mixed))
    out["accuracy_pass_s"] = acc_wall
    out["unfused"] = serve_unfused(torch, dev, cfg, params_last, held, card)
    out["adapt"] = serve_adapt(torch, dev, cfg, params_last, held, card)
    for part in ("unfused", "adapt"):
        for name in KERNELS:
            out["counts"][name] += out[part]["counts"][name]
    return out


def serve_unfused(torch, dev, cfg, params, held, card: str) -> dict:
    """fused=False at the deployment's settings for each scheme: the raw
    encode (B3 minwise, B4 OPH) and the widened product (B7; oph_zero's
    masked product has no kernel in either package, so it counts on
    bbit_linear_fwd_plain and nowhere else), against the fused path."""
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.serving import HashedClassifierEngine
    docs = held[:SERVE_UNFUSED_DOCS]
    total = {name: 0 for name in KERNELS}
    out = {}
    for scheme, encode in (("minwise", "minhash"), ("oph", "oph"),
                           ("oph_zero", "oph")):
        kw = CONFIG.serve_kwargs(scheme=scheme)
        with HashedClassifierEngine(params, cfg, seed=HASH_SEED, device=dev,
                                    fused=False, precompile=False,
                                    **kw) as eng:
            ops.reset_counts()
            futs = eng.submit_many(docs)
            eng.flush()
            got = np.asarray([f.result(timeout=SERVE_WAIT_S) for f in futs],
                             np.float32)
            torch.cuda.synchronize()
            counts = ops.counts()
        with HashedClassifierEngine(params, cfg, seed=HASH_SEED, device=dev,
                                    precompile=False, **kw) as fused:
            want = fused.score_docs(docs)
        stray = {k: v for k, v in counts.items() if k.endswith("_plain")
                 and v}
        if scheme == "oph_zero":
            ok = (counts["oph"] >= 1 and counts["bbit_linear_fwd"] == 0
                  and set(stray) == {"bbit_linear_fwd_plain"})
        else:
            ok = (counts[encode] >= 1 and counts["bbit_linear_fwd"] >= 1
                  and not stray)
        err = float(np.abs(got - want).max())
        out[scheme] = {"max_abs_err_vs_fused": err,
                       "launches": {k: v for k, v in counts.items() if v}}
        print(f"serve: fused=False {scheme}: {len(docs)} docs, launches "
              f"{out[scheme]['launches']}, vs fused max_abs_err {err} "
              f"card={card}")
        if not ok:
            fail(f"serve: fused=False {scheme} left its kernels: {counts}")
        if not np.allclose(got, want, **TOL):
            fail(f"serve: fused=False {scheme} vs fused {err}")
        for name in KERNELS:
            total[name] += counts[name]
    out["counts"] = total
    return out


def serve_adapt(torch, dev, cfg, params, held, card: str) -> dict:
    """adapt_every on a skewed stream at the deployment's settings: the
    lane grid re-derived on a background thread (its new shapes warmed on
    the card first) while submits go on; no request fails across the
    swap, and every score equals score_docs."""
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.serving import HashedClassifierEngine
    rng = np.random.default_rng(2)
    skewed = [held[i % len(held)][:int(rng.integers(8, 48))]
              for i in range(2 * ADAPT_DOCS)]
    kw = CONFIG.serve_kwargs(adapt_every=ADAPT_EVERY)
    with HashedClassifierEngine(params, cfg, seed=HASH_SEED, device=dev,
                                **kw) as eng:
        before = eng.nnz_buckets
        ops.reset_counts()
        futs = []
        for lo in range(0, ADAPT_DOCS, ROWS):
            futs += eng.submit_many(skewed[lo: lo + ROWS])
            time.sleep(0.002)
        deadline = time.time() + SERVE_WAIT_S
        while eng.rebuckets == 0 and time.time() < deadline:
            time.sleep(0.01)
        for lo in range(ADAPT_DOCS, 2 * ADAPT_DOCS, ROWS):
            futs += eng.submit_many(skewed[lo: lo + ROWS])
        eng.flush()
        got = np.asarray([f.result(timeout=SERVE_WAIT_S) for f in futs],
                         np.float32)
        torch.cuda.synchronize()
        counts = ops.counts()
        want = pinned_scores(eng, skewed, eng.current_weights())
        out = {"before": list(before), "after": list(eng.nnz_buckets),
               "rebuckets": eng.rebuckets,
               "counts": {name: counts[name] for name in KERNELS}}
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    print(f"serve: adapt_every={ADAPT_EVERY} on {len(skewed)} docs of 8-47 "
          f"ids: lanes {out['before']} -> {out['after']} "
          f"(rebuckets={out['rebuckets']}), every score equal to "
          f"score_docs={np.array_equal(got, want)} card={card}")
    if out["rebuckets"] < 1 or stray or not np.array_equal(got, want):
        fail(f"serve: adapt_every failed: {out}, plain calls {stray}")
    return out

def phase_paper(torch, dev, card: str, data: dict, errs: dict) -> dict:
    """configs/rcv1_bbit.py's width on the train phase's corpus: k=500,
    b=16 through B3 and TRON over the (500, 65536, 1) table; the
    abstract's k=30, b=12 (B3, then B7/B8 at V=4096); oph_zero at k=256
    (B4) against the host numpy encode."""
    from repro_torch.core.bbit import unpack_codes
    from repro_torch.core.oph import OPH_EMPTY_CODE
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data.hashed_dataset import (_length_sorted_chunks,
                                                 preprocess_rows)
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import minhash as mh
    from repro_torch.kernels import ops
    from repro_torch.models.linear import BBitLinearConfig
    from repro_torch.train.linear_trainer import train_bbit_liblinear

    rows, labels = data["rows"], data["labels"]
    n = TRAIN_ROWS
    runs, codes, rates = {}, {}, {}

    def encode(name, **kw):
        codes[name], sec = timed(torch, lambda: preprocess_rows(
            rows, seed=HASH_SEED, chunk=PREPROCESS_CHUNK, device=dev, **kw))
        rates[name] = len(rows) / sec
        print(f"paper: preprocess_rows {name} docs={len(rows)}: {sec:.3f} s "
              f"({rates[name]:.0f} docs/s) card={card}")

    def fit(name, k, b, loss):
        c = codes[f"minwise k={k} b={b}"]
        runs[f"{name} {loss}"] = train_bbit_liblinear(
            c[:n], labels[:n], c[n:], labels[n:],
            BBitLinearConfig(k=k, b=b, n_classes=N_CLASSES), loss=loss,
            C=TRAIN_C, max_iter=TRAIN_ITERS, device=dev)

    ops.reset_counts()
    encode(f"minwise k={PAPER_K} b={PAPER_B}", k=PAPER_K, b=PAPER_B,
           scheme="minwise")
    for loss in ("logistic", "squared_hinge"):
        fit(f"bbit minwise k={PAPER_K} b={PAPER_B}", PAPER_K, PAPER_B, loss)
    encode(f"minwise k={ABSTRACT_K} b={ABSTRACT_B}", k=ABSTRACT_K,
           b=ABSTRACT_B, scheme="minwise")
    fit(f"bbit minwise k={ABSTRACT_K} b={ABSTRACT_B}", ABSTRACT_K,
        ABSTRACT_B, "logistic")
    encode(f"oph_zero k={K} b={B}", k=K, b=B, scheme="oph_zero")
    counts = ops.counts()

    for name in ("minhash", "oph", "bbit_linear_fwd", "bbit_linear_bwd_dw"):
        if counts[name] < 1:
            fail(f"paper: kernel {name} was not launched")
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if stray:
        fail(f"paper: the main path left the kernels: {stray}")
    print(f"paper: launches {json.dumps(counts)}")
    check_plan_builds("paper", counts, len(runs))
    plain_runs = {}
    for k, b, losses in ((PAPER_K, PAPER_B, ("logistic", "squared_hinge")),
                         (ABSTRACT_K, ABSTRACT_B, ("logistic",))):
        for loss in losses:
            name = f"bbit minwise k={k} b={b} {loss}"
            plain_runs[name] = plain_fit(torch, dev,
                                         codes[f"minwise k={k} b={b}"],
                                         labels, k, b, loss)
            same_fit("paper", name, runs[name], plain_runs[name], card)
    for name, res in runs.items():
        print(f"paper: {name} test_acc={res.test_acc} train_acc="
              f"{res.train_acc} tron_iters={res.n_iter} objective="
              f"{res.objective} seconds={res.train_seconds} card={card}")
        if not np.isfinite(res.objective):
            fail(f"{name}: objective not finite")
        limit = 0.9 if name.endswith("logistic") else 0.85
        if res.test_acc <= limit:
            fail(f"{name}: test accuracy <= {limit}")
    vw = data["vw_wide"]
    short = runs[f"bbit minwise k={ABSTRACT_K} b={ABSTRACT_B} logistic"]
    print(f"paper: b-bit k={ABSTRACT_K} b={ABSTRACT_B} "
          f"({ABSTRACT_K * ABSTRACT_B} bits/doc) test_acc={short.test_acc} "
          f"vs VW m={VW_WIDE} ({32 * VW_WIDE} bits/doc) test_acc="
          f"{vw.test_acc} (reported, not gated: the corpus is separable)")

    check_paper_shapes(torch, dev, labels,
                       codes[f"minwise k={PAPER_K} b={PAPER_B}"],
                       runs[f"bbit minwise k={PAPER_K} b={PAPER_B} "
                            "logistic"].params, errs)
    sel, idx, nnz, total = raw_chunk(torch, dev, rows, first=True)
    a, b = make_scheme("minwise", PAPER_K, HASH_SEED).hash_params(dev)
    want = (mh.minhash_plain(idx, nnz, a, b) & ((1 << PAPER_B) - 1)).cpu()
    same = np.array_equal(codes[f"minwise k={PAPER_K} b={PAPER_B}"][sel],
                          want.numpy().astype(np.uint16))
    print(f"check: preprocess_rows k={PAPER_K} b={PAPER_B} codes of the "
          f"first chunk ({len(sel)} docs, {total} nonzeros) vs minhash's "
          f"plain version: equal={same}")
    if not same:
        fail(f"k={PAPER_K} codes differ from B3's plain version")

    sch = make_scheme("oph_zero", K, HASH_SEED)
    got = codes[f"oph_zero k={K} b={B}"]
    empties = 0
    for sel in _length_sorted_chunks(rows, PREPROCESS_CHUNK):
        idx, nnz = pad_rows([rows[i] for i in sel], pad_to_multiple=1)
        packed, empty = sch.encode_packed_numpy(idx, nnz, B)
        host = unpack_codes(packed, K, B)
        mask = np.unpackbits(empty, axis=1, count=K).astype(bool)
        host[mask] = OPH_EMPTY_CODE
        empties += int(mask.sum())
        if not np.array_equal(got[sel], host):
            fail("oph_zero codes differ from the host numpy encode")
    print(f"check: preprocess_rows oph_zero k={K} b={B} codes of all "
          f"{len(rows)} docs ({empties} empty bins) equal the host numpy "
          "encode (encode_packed_numpy, unpacked, sentinel applied)")
    summary = {"counts": counts, "docs_per_s": rates,
               "runs": fit_summary(runs), "plain_runs": fit_summary(plain_runs)}
    return summary, {
        "codes": codes[f"minwise k={PAPER_K} b={PAPER_B}"],
        "params": runs[f"bbit minwise k={PAPER_K} b={PAPER_B} "
                       "logistic"].params}


def check_paper_shapes(torch, dev, labels, codes, params, errs):
    """B7 and B8 against their plain versions at the paper fits' own
    shape, (16,000 x 500) codes into a (500, 65536, 1) table: the k=500,
    b=16 codes, the logistic fit's table and the objective's dout; B8
    twice for the same bytes."""
    from repro_torch.kernels import bbit_linear as bl
    v, n = 1 << PAPER_B, TRAIN_ROWS
    table = params["table"].detach().contiguous()
    x = torch.from_numpy(codes[:n].astype(np.int32)).to(dev)
    y = torch.from_numpy(labels[:n]).to(dev)
    e7 = _close(torch, "bbit_linear_fwd", errs, bl.bbit_linear_fwd(x, table),
                bl.bbit_linear_fwd_plain(x, table),
                bl.bbit_linear_fwd(x, table))
    logits = bl.bbit_linear_fwd_plain(x, table) + params["bias"].detach()
    dout = logistic_dout(torch, logits, y, TRAIN_C)
    fn = bl.bbit_linear_bwd_dw
    fn.clear_plans()
    fresh = fn(x, dout, v)
    cached = fn(x, dout, v)
    fn.clear_plans()
    rebuilt = fn(x, dout, v)
    e8 = _close(torch, "bbit_linear_bwd_dw", errs, fresh,
                bl.bbit_linear_bwd_dw_plain(x, dout, v), cached,
                scale=bl.bbit_linear_bwd_dw_plain(x, dout.abs(), v))
    same = torch.equal(fresh.view(torch.int32), rebuilt.view(torch.int32))
    print(f"check: k={PAPER_K} b={PAPER_B} trained table, V={v} C=1, n={n}:"
          f" bbit_linear_fwd max_abs_err={e7} allclose(1e-5); "
          f"bbit_linear_bwd_dw (logistic dout) max_abs_err={e8} within 1e-5 "
          "of each bin's sum of |terms|; dW bytes equal from a fresh, a "
          f"cached and a rebuilt plan={same}")
    if not same:
        fail("bbit_linear_bwd_dw differs between a fresh and a rebuilt plan")
    del x, table, logits, dout, fresh, cached, rebuilt
    torch.cuda.empty_cache()


def phase_b7_slices(torch, dev, card: str) -> dict:
    """B7 where it walks its bins in slices: the TRON benchmark cell's
    541,919 x 500 training codes (uniform random, with stray codes) into
    a (500, 65536, 1) table in float32 and bfloat16.  Each call must count
    as sliced, be the one pass's bits and lie within 1e-5 of each row's
    sum of absolute terms of the plain version.  → {table type: record}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import bbit_linear as bl
    n, k, v = SLICED_ROWS, PAPER_K, 1 << PAPER_B
    gen = torch.Generator(device=dev).manual_seed(31)
    codes = torch.randint(0, v, (n, k), dtype=torch.int32, device=dev,
                          generator=gen)
    codes[0, :3] = torch.tensor([-1, v, v + 7], dtype=torch.int32)
    codes[n - 1, k - 1] = -(1 << 20)
    seen = torch.zeros(k * v, dtype=torch.bool, device=dev)
    off = v * torch.arange(k, device=dev, dtype=torch.int64)
    for lo in range(0, n, SLICED_CHUNK):
        part = codes[lo:lo + SLICED_CHUNK].to(torch.int64)
        ok = (part >= 0) & (part < v)
        seen[(part + off)[ok]] = True
    touched = int(seen.sum())
    del seen
    wide = torch.randn((k, v, 1), device=dev, generator=gen)
    out = {}
    for name, table in (("float32", wide), ("bfloat16",
                                            wide.to(torch.bfloat16))):
        width = bl.fwd_slices(n, k, v, 1, table.element_size(),
                              _build.l2_bytes(dev.index))
        before = bl.bbit_linear_fwd.sliced.value
        got = bl.bbit_linear_fwd(codes, table)
        torch.cuda.synchronize()
        counted = bl.bbit_linear_fwd.sliced.value - before
        same = _bitwise(torch, got, bl._fwd_launch(codes, table, k, k))
        errs = {}
        for lo in range(0, n, SLICED_CHUNK):
            c = codes[lo:lo + SLICED_CHUNK]
            _close(torch, "bbit_linear_fwd", errs, got[lo:lo + SLICED_CHUNK],
                   bl.bbit_linear_fwd_plain(c, table),
                   scale=bl.bbit_linear_fwd_plain(c, table.abs()))
        shape = f"n={n} k={k} V={v} C=1 {name} table"
        print(f"b7_slices: bbit_linear_fwd {shape}: {width} bins a slice, "
              f"counted as sliced {counted}, bitwise the one pass={same}, "
              f"vs plain max_abs_err={errs['bbit_linear_fwd']} within 1e-5 "
              "of each row's sum of |terms|")
        if counted != 1 or width >= k:
            fail(f"bbit_linear_fwd at {shape} did not take the slices")
        if not same:
            fail(f"bbit_linear_fwd at {shape} is not the one pass's bits")
        bnd = bound(4 * n * k + table.element_size() * touched + 4 * n,
                    n * k, PEAK_F32_OPS_PER_S)
        out[name] = dict(
            shape=shape, width=width, max_abs_err=errs["bbit_linear_fwd"],
            ms=time_ms(torch, lambda: bl.bbit_linear_fwd(codes, table), 20),
            one_pass_ms=time_ms(
                torch, lambda: bl._fwd_launch(codes, table, k, k), 20),
            bound_ms=bnd[0], bound_by=bnd[1])
        r = out[name]
        print(f"timing: bbit_linear_fwd {shape} sliced ms={r['ms']} "
              f"(one pass {r['one_pass_ms']}) bound_ms={bnd[0]} ({bnd[1]}) "
              f"card={card}")
        del got, table
    del codes, wide
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
def _words(torch, t):
    """A tensor's bits: int16 for bfloat16, int32 for float32."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bitwise(torch, a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_words(torch, a),
                                              _words(torch, b))


def bf16_kernels(torch, dev, data, paper, card: str) -> dict:
    """B5-B8 at bfloat16 at the main paths' shapes: B5 and B7 against the
    same kernel on the table widened (bitwise) and their plain versions
    (allclose); B6 and B8 against the float32 instantiation rounded to
    bfloat16 (bitwise), the float32 one against the plain version (1e-5
    of each bin's sum of absolute terms).  Then each bfloat16
    instantiation timed beside the float32 one on the same inputs, its
    plain version and its one-call yardstick.  → {"errs", "main"}."""
    import torch.nn.functional as F
    from repro_torch.core.bbit import packed_width, unpack_codes_torch
    from repro_torch.data.hashed_dataset import preprocess_rows_packed
    from repro_torch.data.packing import pad_rows
    from repro_torch.core.schemes import make_scheme
    from repro_torch.kernels import bbit_linear as bl

    bf = torch.bfloat16
    rows, n = data["rows"], TRAIN_ROWS
    gen = torch.Generator().manual_seed(22)
    errs, main, fp32 = {}, {}, {}
    v, pv = 1 << B, 1 << PAPER_B

    def record(name, shape, ms, ms32, plain, bnd, lib):
        main[f"{name}_bf16"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                    bound_by=bnd[1], library_ms=lib)
        fp32[name] = ms32
        print(f"timing: {name} bf16 table {shape} ms={ms} (float32 table "
              f"{ms32}) plain_ms={plain} bound_ms={bnd[0]} ({bnd[1]}) "
              f"library_ms={lib} card={card}")

    # B5 at the engine's batch: 64 held-out documents in the 8,192 lane,
    # encoded by B2 (oph, k=256, b=8)
    idx, nnz = pad_rows(rows[n:n + ROWS], pad_to_multiple=1)
    full = np.zeros((ROWS, NNZ_BUCKETS[-1]), np.int32)
    full[:, :idx.shape[1]] = idx
    packed, _ = make_scheme("oph", K, HASH_SEED).encode_packed(
        torch.from_numpy(full).to(dev), torch.from_numpy(nnz).to(dev), B)
    table = (0.01 * torch.randn((K, v, 1), generator=gen)).to(dev, bf)
    wide = table.float()
    got = bl.bbit_linear_packed_fwd(packed, table, k=K, bits=B)
    same = _bitwise(torch, got, bl.bbit_linear_packed_fwd(packed, wide, k=K,
                                                          bits=B))
    plain = bl.bbit_linear_packed_fwd_plain(packed, table, k=K, bits=B)
    errs["bbit_linear_packed_fwd_bf16"] = float((got - plain).abs().max())
    ok = torch.allclose(got, plain, **TOL)
    print(f"bf16: bbit_linear_packed_fwd rows={ROWS} k={K} b={B}: bitwise "
          f"the widened table's={same}; vs plain max_abs_err="
          f"{errs['bbit_linear_packed_fwd_bf16']} allclose(1e-5)={ok}")
    if not same or not ok:
        fail("bbit_linear_packed_fwd at bfloat16 departs")
    flat = (torch.arange(K, device=dev)[None, :] * v
            + unpack_codes_torch(packed, K, B))
    touched = int(torch.unique(flat).numel())
    record("bbit_linear_packed_fwd", f"rows={ROWS} k={K} V={v} C=1",
           time_ms(torch, lambda: bl.bbit_linear_packed_fwd(
               packed, table, k=K, bits=B), 500),
           time_ms(torch, lambda: bl.bbit_linear_packed_fwd(
               packed, wide, k=K, bits=B), 500),
           time_ms(torch, lambda: bl.bbit_linear_packed_fwd_plain(
               packed, table, k=K, bits=B), 50),
           bound(ROWS * packed_width(K, B) + 2 * touched + 4 * ROWS,
                 ROWS * K, PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: F.embedding_bag(
               flat, table.view(K * v, 1), mode="sum"), 500))

    # B6 at the stream batch: 1,024 training documents (oph, k=256, b=8)
    pk, _ = preprocess_rows_packed(rows[:STREAM_BATCH], K, B, scheme="oph",
                                   seed=HASH_SEED, device=dev)
    pk = torch.from_numpy(pk).to(dev)
    dout = torch.randn((STREAM_BATCH, 1), generator=gen).to(dev)
    kw = dict(k=K, bits=B)
    g16 = bl.bbit_linear_packed_bwd_dw(pk, dout, v, dtype=bf, **kw)
    g32 = bl.bbit_linear_packed_bwd_dw(pk, dout, v, **kw)
    plain = bl.bbit_linear_packed_bwd_dw_plain(pk, dout, v, **kw)
    same = _bitwise(torch, g16, g32.to(bf))
    e32 = _close(torch, "bbit_linear_packed_bwd_dw", {}, g32, plain,
                 scale=bl.bbit_linear_packed_bwd_dw_plain(pk, dout.abs(), v,
                                                          **kw))
    errs["bbit_linear_packed_bwd_dw_bf16"] = float(
        (g16.float() - plain.to(bf).float()).abs().max())
    print(f"bf16: bbit_linear_packed_bwd_dw rows={STREAM_BATCH} k={K} b={B}:"
          f" bitwise the float32 dW rounded={same}; float32 vs plain "
          f"max_abs_err={e32}; bf16 vs plain rounded max_abs_err="
          f"{errs['bbit_linear_packed_bwd_dw_bf16']}")
    if not same:
        fail("bbit_linear_packed_bwd_dw at bfloat16 is not the float32 dW "
             "rounded")
    f1 = (torch.arange(K, device=dev)[None, :] * v
          + unpack_codes_torch(pk, K, B)).reshape(-1)
    wr = dout[:, 0].repeat_interleave(K)
    record("bbit_linear_packed_bwd_dw", f"n={STREAM_BATCH} k={K} V={v} C=1",
           time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw(
               pk, dout, v, dtype=bf, **kw), 200),
           time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw(
               pk, dout, v, **kw), 200),
           time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw_plain(
               pk, dout, v, **kw).to(bf), 20),
           bound(STREAM_BATCH * packed_width(K, B) + 4 * STREAM_BATCH
                 + 2 * K * v, STREAM_BATCH * K, PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: torch.bincount(
               f1, weights=wr, minlength=K * v).to(bf), 200))

    # B7 and B8 at the paper fits' shape: the k=500, b=16 codes of the
    # 16,000 training documents, the logistic TRON fit's table rounded
    x = torch.from_numpy(paper["codes"][:n].astype(np.int32)).to(dev)
    ptable = paper["params"]["table"].detach().to(bf).contiguous()
    pwide = ptable.float()
    got = bl.bbit_linear_fwd(x, ptable)
    same = _bitwise(torch, got, bl.bbit_linear_fwd(x, pwide))
    plain = bl.bbit_linear_fwd_plain(x, ptable)
    errs["bbit_linear_fwd_bf16"] = float((got - plain).abs().max())
    ok = torch.allclose(got, plain, **TOL)
    print(f"bf16: bbit_linear_fwd n={n} k={PAPER_K} V={pv}: bitwise the "
          f"widened table's={same}; vs plain max_abs_err="
          f"{errs['bbit_linear_fwd_bf16']} allclose(1e-5)={ok}")
    if not same or not ok:
        fail("bbit_linear_fwd at bfloat16 departs")
    pdout = torch.randn((n, 1), generator=gen).to(dev)
    d16 = bl.bbit_linear_bwd_dw(x, pdout, pv, bf)
    d32 = bl.bbit_linear_bwd_dw(x, pdout, pv)
    plain = bl.bbit_linear_bwd_dw_plain(x, pdout, pv)
    same = _bitwise(torch, d16, d32.to(bf))
    e32 = _close(torch, "bbit_linear_bwd_dw", {}, d32, plain,
                 scale=bl.bbit_linear_bwd_dw_plain(x, pdout.abs(), pv))
    errs["bbit_linear_bwd_dw_bf16"] = float(
        (d16.float() - plain.to(bf).float()).abs().max())
    print(f"bf16: bbit_linear_bwd_dw n={n} k={PAPER_K} V={pv} (a cached "
          f"plan): bitwise the float32 dW rounded={same}; float32 vs plain "
          f"max_abs_err={e32}; bf16 vs plain rounded max_abs_err="
          f"{errs['bbit_linear_bwd_dw_bf16']}")
    if not same:
        fail("bbit_linear_bwd_dw at bfloat16 is not the float32 dW rounded")
    del plain, d16, d32
    pflat = (torch.arange(PAPER_K, device=dev)[None, :] * pv
             + x.to(torch.int64))
    ptouched = int(torch.unique(pflat).numel())
    shape = f"n={n} k={PAPER_K} V={pv} C=1"
    record("bbit_linear_fwd", shape,
           time_ms(torch, lambda: bl.bbit_linear_fwd(x, ptable), 50),
           time_ms(torch, lambda: bl.bbit_linear_fwd(x, pwide), 50),
           time_ms(torch, lambda: bl.bbit_linear_fwd_plain(x, ptable), 10),
           bound(4 * n * PAPER_K + 2 * ptouched + 4 * n, n * PAPER_K,
                 PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: F.embedding_bag(
               pflat, ptable.view(PAPER_K * pv, 1), mode="sum"), 50))
    pf1 = pflat.reshape(-1)
    pw = pdout[:, 0].repeat_interleave(PAPER_K)
    record("bbit_linear_bwd_dw", shape,
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw(x, pdout, pv, bf),
                   50),
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw(x, pdout, pv), 50),
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw_plain(
               x, pdout, pv).to(bf), 10),
           bound(4 * n * PAPER_K + 4 * n + 2 * PAPER_K * pv, n * PAPER_K,
                 PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: torch.bincount(
               pf1, weights=pw, minlength=PAPER_K * pv).to(bf), 20))
    bl.bbit_linear_bwd_dw.clear_plans()
    del x, pflat, pf1, pw, ptable, pwide
    torch.cuda.empty_cache()
    return {"errs": errs, "main": main, "float32_ms": fp32}


def phase_bf16(torch, dev, card: str, data: dict, handover: dict,
               paper: dict) -> dict:
    """bfloat16 tables (``param_dtype="bfloat16"``): B5-B8 at bfloat16
    against the float32 instantiations and the plain versions; the stream
    phase's oph archive fitted at bfloat16, serially (resumed too) and
    folding 2 logical slots, each held to the CPU through the rounding
    replay; train_bbit_sgd at the paper's k=500, b=16; an engine at the
    rcv1_oph width serving the bfloat16 table bitwise as the widened one;
    the bfloat16 kernels timed."""
    return bf16_in(torch, dev, card, data, handover["oph_root"], paper,
                   os.path.join(handover["stream_work"], "bf16"))


def bf16_in(torch, dev, card: str, data: dict, root: str, paper: dict,
            work: str) -> dict:
    import dataclasses
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.data.hashed_dataset import preprocess_rows_packed
    from repro_torch.kernels import ops
    from repro_torch.models.linear import (BBitLinearConfig,
                                           bbit_scores_packed)
    from repro_torch.serving import HashedClassifierEngine
    from repro_torch.train.linear_trainer import train_bbit_sgd
    from repro_torch.train.metrics import accuracy, trees_bitwise_equal
    from repro_torch.train.streaming import fit_streaming

    rows, labels = data["rows"], data["labels"]
    n = TRAIN_ROWS
    cfg = dataclasses.replace(CONFIG.linear_config(), param_dtype="bfloat16")
    kw = CONFIG.stream_kwargs(seed=CONFIG.seed)
    dp_kw = dict(data_parallel=DP_WORLD, elastic=True)
    kern = bf16_kernels(torch, dev, data, paper, card)
    out = {"card": card, "kernels": kern}

    def fit(device=dev, **extra):
        return fit_streaming(root, cfg, device=device, **dict(kw, **extra))

    # -- the main path on the card: every launch counted from here ----
    ops.reset_counts()
    u = fit()
    fold = fit(**dp_kw)
    ck = os.path.join(work, "ckpt")
    part = fit(ckpt_dir=ck, stop_after_shards=STREAM_SHARDS // 2)
    resumed = fit(ckpt_dir=ck)
    held, _ = preprocess_rows_packed(rows[n:], K, B, scheme="oph",
                                     seed=HASH_SEED, device=dev)
    held = torch.from_numpy(held).to(dev)
    with torch.no_grad():
        acc_eval = accuracy(bbit_scores_packed(u.eval_params, held, cfg) > 0,
                            labels[n:])
        acc_raw = accuracy(bbit_scores_packed(u.params, held, cfg) > 0,
                           labels[n:])
    m = LINEAR_STEPS * LINEAR_BATCH
    pcfg = BBitLinearConfig(k=PAPER_K, b=PAPER_B, n_classes=N_CLASSES,
                            param_dtype="bfloat16")
    pcodes = paper["codes"]
    sgd = train_bbit_sgd(pcodes[:m], labels[:m], pcodes[n:], labels[n:],
                         pcfg, epochs=1, batch_size=LINEAR_BATCH, lr=1e-2,
                         seed=LINEAR_SEED, device=dev)
    engines = {}
    for name, params in (("bf16", u.params),
                         ("widened", {k: t.float()
                                      for k, t in u.params.items()})):
        with HashedClassifierEngine(params, cfg, seed=HASH_SEED,
                                    scheme="oph", device=dev,
                                    max_batch=ROWS, nnz_buckets=NNZ_BUCKETS,
                                    row_buckets=(1, ROWS)) as eng:
            engines[name] = (eng.params["table"].dtype,
                             eng.score_docs(rows[n:]))
    torch.cuda.synchronize()
    counts = ops.counts()
    # -- end of the main path -------------------------------------------
    out["counts"] = counts
    out["fit"] = fit_line(u)
    print(f"bf16: fit_streaming oph archive (configs/rcv1_oph.py streaming "
          f"settings, bfloat16 table) {json.dumps(out['fit'])}; params "
          f"{u.params['table'].dtype}, eval params "
          f"{u.eval_params['table'].dtype} card={card}")
    out["fold"] = fit_line(fold)
    print(f"bf16: the same fit folding {DP_WORLD} logical slots "
          f"{json.dumps(out['fold'])}; params {fold.params['table'].dtype}, "
          f"eval params {fold.eval_params['table'].dtype}")
    for res, steps in ((u, STREAM_STEPS), (fold, DP_STEPS)):
        if (res.n_steps != steps or not res.completed
                or res.params["table"].dtype != torch.bfloat16
                or res.eval_params["table"].dtype != torch.float32):
            fail("bf16: the stream fits' steps or dtypes")
    same = (not part.completed and resumed.completed
            and trees_bitwise_equal(u.params, resumed.params)
            and trees_bitwise_equal(u.avg_params, resumed.avg_params))
    out["resume_bitwise"] = same
    out["test_acc"] = {"eval": acc_eval, "raw": acc_raw}
    print(f"bf16: stopped after {STREAM_SHARDS // 2} shards and resumed: "
          f"bitwise the uninterrupted fit={same}; held-out accuracy over "
          f"{len(rows) - n} rows (B2, B5): eval params {acc_eval}, bfloat16 "
          f"params {acc_raw}")
    if not same or acc_eval <= 0.9:
        fail(f"bf16: resume bitwise={same}, held-out accuracy {acc_eval}")
    out["sgd"] = dict(seconds=sgd.train_seconds, steps=sgd.n_iter,
                      test_acc=sgd.test_acc, train_acc=sgd.train_acc,
                      table_dtype=str(sgd.params["table"].dtype))
    print(f"bf16: train_bbit_sgd AdamW k={PAPER_K} b={PAPER_B} (a "
          f"{PAPER_K * (1 << PAPER_B) * 2 / 1e6} MB bfloat16 table) "
          f"{json.dumps(out['sgd'])} card={card}")
    if (sgd.n_iter != LINEAR_STEPS or sgd.test_acc <= 0.9
            or sgd.params["table"].dtype != torch.bfloat16):
        fail(f"bf16: train_bbit_sgd {out['sgd']}")
    served = np.array_equal(engines["bf16"][1], engines["widened"][1])
    acc_served = accuracy(engines["bf16"][1] > 0, labels[n:])
    out["serve"] = dict(bitwise=served, test_acc=acc_served,
                        table_dtype=str(engines["bf16"][0]))
    print(f"bf16: engine oph k={K} b={B} on the bfloat16 params "
          f"(table kept {engines['bf16'][0]}) over {len(rows) - n} held-out "
          f"docs: scores bitwise the widened table's={served}; accuracy "
          f"{acc_served}")
    if not served or engines["bf16"][0] != torch.bfloat16:
        fail("bf16: the engine's scores on the bfloat16 table")
    need = ("bbit_linear_packed_fwd_bf16", "bbit_linear_packed_bwd_dw_bf16",
            "bbit_linear_fwd_bf16", "bbit_linear_bwd_dw_bf16", "oph_pack")
    missing = [name for name in need if counts[name] < 1]
    stray = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    print(f"bf16: launches {json.dumps(counts)}")
    if missing or stray:
        fail(f"bf16: kernels not launched {missing}, plain calls {stray}")

    # -- the same fits on the CPU, and the rounding replay --------------
    def gap(a, b):
        err = max(float((a[k].cpu().float() - b[k].float()).abs().max())
                  for k in a)
        close = all(torch.allclose(a[k].cpu().float(), b[k].float(),
                                   **STREAM_CPU_TOL) for k in a)
        return err, close

    def held_to(res, cpu):
        err, close = gap(res.params, cpu.params)
        err_avg, close_avg = gap(res.avg_params, cpu.avg_params)
        return dict(params_max_abs_err=err, avg_max_abs_err=err_avg,
                    close=close and close_avg)

    for name, res, extra in (("cpu", u, {}), ("fold_cpu", fold, dp_kw)):
        cpu = fit(device="cpu", **extra)
        out[name] = dict(fit_line(cpu), **held_to(res, cpu))
        print(f"bf16: {name} fit steps={cpu.n_steps} progressive_acc="
              f"{cpu.progressive_acc} (card {res.progressive_acc}); params "
              f"max_abs_err={out[name]['params_max_abs_err']} (average "
              f"{out[name]['avg_max_abs_err']}) allclose(1e-4, 1e-5)="
              f"{out[name]['close']}")
        if (cpu.n_steps, cpu.examples_seen) != (res.n_steps,
                                                res.examples_seen):
            fail(f"bf16: the {name} fit's steps")
        if out[name]["close"]:
            continue
        rep = rounding_replay(
            torch, replay_hooks("bf16"),
            {"res": res, "fit": lambda: fit(**extra)},
            lambda: fit(device="cpu", **extra))
        replay = rep.pop("replay")
        out[name]["replay"] = dict(rep, **held_to(res, replay))
        r = out[name]["replay"]
        print(f"bf16: {name} rounding replay: {rep['flips']} flips in "
              f"{rep['calls']} roundings (recorded {rep['recorded']}), "
              f"{rep['bad']} not at a boundary (worst input gap "
              f"{rep['worst']}); the card's recorded fit repeats its bits="
              f"{rep['card_repeats']}; the replay vs the card max_abs_err="
              f"{r['params_max_abs_err']} (average {r['avg_max_abs_err']}) "
              f"allclose(1e-4, 1e-5)={r['close']}")
        if (rep["bad"] or not rep["card_repeats"] or not r["close"]
                or rep["calls"] != rep["recorded"]):
            fail(f"bf16: the card's {name} fit departs from the CPU's "
                 "replay")
    return out


def phase_search(torch, dev, card: str, rows, errs: dict) -> dict:
    """The corpus packed at k=256, b=8 (B2) into a BandedLSHIndex; exact
    copies and near-duplicates ranked by B10; recall@10 against a full
    scan whose distances and top-10 are held to B10's plain version."""
    from repro_torch.data.hashed_dataset import preprocess_rows_packed
    from repro_torch.kernels import hamming as hd
    from repro_torch.kernels import ops
    from repro_torch.retrieval import BandedLSHIndex

    def pack(docs):
        return preprocess_rows_packed(docs, k=K, b=B, scheme="oph",
                                      seed=HASH_SEED, chunk=PREPROCESS_CHUNK,
                                      device=dev)[0]

    ops.reset_counts()
    packed, enc_s = timed(torch, lambda: pack(rows))
    index = BandedLSHIndex(k=K, b=B, rows_per_band=ROWS_PER_BAND,
                           device=dev)
    _, ins_s = timed(torch, lambda: index.insert(list(range(len(rows))),
                                                 packed))
    rng = np.random.default_rng(0)
    picks = rng.choice(len(rows), size=2 * SEARCH_QUERIES, replace=False)
    exact, near = picks[:SEARCH_QUERIES], picks[SEARCH_QUERIES:]
    queries = ([rows[i] for i in exact]
               + [rows[i][rng.random(rows[i].size) > DROP_FRAC]
                  for i in near])
    q_packed = pack(queries)
    if not np.array_equal(q_packed[:SEARCH_QUERIES], packed[exact]):
        fail("search: exact copies encode to other bytes than the index's")
    encode_counts = ops.counts()
    ops.reset_counts()
    results, query_s = timed(torch, lambda: [
        index.query(q, top_k=TOP_K) for q in q_packed])
    counts = ops.counts()
    if counts["hamming_distance"] < 1 or counts["hamming_distance_plain"]:
        fail(f"search: the queries left kernel hamming_distance: {counts}")
    n_cands = np.array([len(index.candidates(q)) for q in q_packed])

    misses = []
    for j, (ids, sims) in enumerate(results):
        src = int(picks[j])
        if j < SEARCH_QUERIES:
            tied = [i for i, sim in zip(ids, sims) if sim == 1.0]
            if not len(sims) or sims[0] != 1.0 or src not in tied:
                misses.append(("exact", src, ids[:3], sims[:3].tolist()))
        elif src not in ids:
            misses.append(("near", src, ids[:3], sims[:3].tolist()))
    if misses:
        fail(f"search: {len(misses)} queries missed their source: "
             f"{misses[:5]}")

    table = torch.from_numpy(packed).to(dev)
    hits, err, ties, scans = 0, 0, 0, 0
    for j, (q, (ids, _)) in enumerate(zip(q_packed, results)):
        qd = torch.from_numpy(q).to(dev)
        full_i, _ = ops.hamming_topk(qd, table, k=K, bits=B, topk=TOP_K)
        scans += 1
        hits += len(set(full_i.tolist()) & set(ids))
        if j % SEARCH_CHECK_EVERY:
            continue
        # a sample of the queries: B10 against its plain version over
        # the whole index, and the full scan's top-10 against the plain
        # distances' stable order
        dist = hd.hamming_distance(qd, table)
        plain = hd.hamming_distance_plain(qd, table)
        scans += 1
        if j == 0:
            same = torch.equal(dist, hd.hamming_distance(qd, table))
            scans += 1
            if not same:
                fail("search: hamming_distance differs between two calls")
        e = int_err(torch, dist, plain)
        if e:
            fail(f"search: hamming_distance differs from its plain version "
                 f"(max_abs_err={e})")
        err = max(err, e)
        d = plain.cpu().numpy()
        want_i = np.argsort(d, kind="stable")[:TOP_K]
        if not np.array_equal(full_i.cpu().numpy(), want_i):
            fail("search: full-scan top-10 differs from the plain distances'")
        ties += int(np.sum(d == d[want_i[-1]]) > 1)
    checked = -(-len(q_packed) // SEARCH_CHECK_EVERY)
    errs["hamming_distance"] = max(errs.get("hamming_distance", 0), err)
    recall = hits / (len(q_packed) * TOP_K)
    stats = index.stats()
    print(f"search: {len(rows)} docs packed (k={K} b={B}, oph) in {enc_s:.3f}"
          f" s, indexed in {ins_s:.3f} s ({stats['buckets']} buckets, "
          f"{stats['bands']} bands of {ROWS_PER_BAND} codes); "
          f"{len(q_packed)} queries in {query_s:.3f} s "
          f"({len(q_packed) / query_s:.1f} queries/s), candidates per "
          f"query median {np.median(n_cands):.0f} mean {n_cands.mean():.1f} "
          f"max {n_cands.max()} card={card}")
    print(f"search: {SEARCH_QUERIES} exact copies at rank 1 with sim 1.0, "
          f"{SEARCH_QUERIES} near-duplicates ({DROP_FRAC:.0%} of ids "
          f"dropped) in the top {TOP_K}; recall@{TOP_K} of the index vs the "
          f"full scan {recall}; on {checked} of the queries, full-scan "
          f"distances vs hamming_distance's plain version over {len(rows)} "
          f"rows: max_abs_err={err}, top-{TOP_K} indices equal ({ties} "
          f"with a tie at the boundary), run-to-run equal=True")
    print(f"search: launches {json.dumps(counts)} (encode: "
          f"oph_pack={encode_counts['oph_pack']}; full scans and checks: "
          f"{scans} more hamming_distance launches, not counted)")
    typical = int(np.argmin(np.abs(n_cands - np.median(n_cands))))
    slots = index.candidates(q_packed[typical])
    return {"counts": {**counts, "oph_pack": encode_counts["oph_pack"]},
            "recall": recall, "candidates": n_cands.tolist(),
            "table": table, "query": torch.from_numpy(
                q_packed[typical]).to(dev),
            "cands": torch.from_numpy(packed[slots]).to(dev)}


def lane_batch(torch, dev, docs, lane):
    """ROWS real documents of one nnz lane, padded to the lane's width."""
    from repro_torch.data.packing import pad_rows
    lo = 0 if lane == NNZ_BUCKETS[0] else NNZ_BUCKETS[0]
    pick = [d for d in docs if lo < len(d) <= lane]
    if not pick:
        fail(f"no document of the corpus falls in the {lane} lane")
    rows = [pick[i % len(pick)] for i in range(ROWS)]
    idx, nnz = pad_rows(rows, pad_to_multiple=1)
    full = np.zeros((ROWS, lane), np.int32)
    full[:, :idx.shape[1]] = idx
    return (torch.from_numpy(full).to(dev), torch.from_numpy(nnz).to(dev),
            int(nnz.sum()))


def check_timed(torch, fe, bl, table, idx, nnz, hashes, where: str):
    """B1, B2 and B5 held to their plain versions at a shape that is timed
    (each row bucket picks its own launch layout): B1's bytes, B2's bytes
    and mask equal, B5's logits within TOL."""
    a, b, oa, ob = hashes
    if int_err(torch, fe.minhash_pack(idx, nnz, a, b, bits=B),
               fe.minhash_pack_plain(idx, nnz, a, b, bits=B)):
        fail(f"minhash_pack at {where} differs from its plain version")
    got = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=B)
    want = fe.oph_pack_plain(idx, nnz, oa, ob, k=K, bits=B)
    if int_err(torch, got[0], want[0]) or int_err(torch, got[1], want[1]):
        fail(f"oph_pack at {where} differs from its plain version")
    logits = bl.bbit_linear_packed_fwd(got[0], table, k=K, bits=B)
    plain = bl.bbit_linear_packed_fwd_plain(got[0], table, k=K, bits=B)
    if not torch.allclose(logits, plain, **TOL):
        fail(f"bbit_linear_packed_fwd at {where} differs from its plain "
             f"version by {float((logits - plain).abs().max())}")
    print(f"timing: {where}: minhash_pack and oph_pack bytes equal, "
          f"bbit_linear_packed_fwd within {TOL}")


def one_row(torch, F, fe, bl, table, idx, nnz, hashes, int_rate: float,
            lane: int, card: str) -> dict:
    """B1, B2 and B5 on serving's one-row bucket: the first document of
    the lane batch → {kernel: record}.  ``hashes``: B1's (a, b), then
    B2's."""
    from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                       unpack_codes_torch)
    a, b, oa, ob = hashes
    check_timed(torch, fe, bl, table, idx, nnz, hashes,
                f"rows=1 lane={lane}")
    total_nnz = int(nnz.sum())
    w_bytes, e_bytes = packed_width(K, B), packed_mask_width(K)
    rec = {}
    ms = time_ms(torch, lambda: fe.minhash_pack(idx, nnz, a, b, bits=B), 200)
    plain = time_ms(torch, lambda: fe.minhash_pack_plain(idx, nnz, a, b,
                                                         bits=B), 3)
    bnd = bound(4 * total_nnz + 4 + 8 * K + w_bytes,
                OPS_PER_MINHASH * K * total_nnz, int_rate)
    rec["minhash_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                               bound_by=bnd[1], library_ms=None)
    ms = time_ms(torch, lambda: fe.oph_pack(idx, nnz, oa, ob, k=K, bits=B),
                 200)
    plain = time_ms(torch, lambda: fe.oph_pack_plain(idx, nnz, oa, ob, k=K,
                                                     bits=B), 10)
    bnd = bound(4 * total_nnz + 4 + 8 + w_bytes + e_bytes,
                OPS_PER_OPH_HASH * total_nnz, int_rate)
    rec["oph_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                           bound_by=bnd[1], library_ms=None)
    packed, _ = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=B)
    flat = (torch.arange(K, device=idx.device)[None, :] * (1 << B)
            + unpack_codes_torch(packed, K, B))
    ms = time_ms(torch, lambda: bl.bbit_linear_packed_fwd(packed, table, k=K,
                                                          bits=B), 500)
    plain = time_ms(torch, lambda: bl.bbit_linear_packed_fwd_plain(
        packed, table, k=K, bits=B), 50)
    weight2d = table.view(K * (1 << B), 1)
    lib = time_ms(torch, lambda: F.embedding_bag(flat, weight2d, mode="sum"),
                  500)
    bnd = bound(w_bytes + 4 * int(torch.unique(flat).numel()) + 4, K,
                PEAK_F32_OPS_PER_S)
    rec["bbit_linear_packed_fwd"] = dict(ms=ms, plain_ms=plain,
                                         bound_ms=bnd[0], bound_by=bnd[1],
                                         library_ms=lib)
    for name, r in rec.items():
        print(f"timing: {name} rows=1 lane={lane} nnz_sum={total_nnz} "
              f"ms={r['ms']} plain_ms={r['plain_ms']} bound_ms="
              f"{r['bound_ms']} ({r['bound_by']}) library_ms="
              f"{r['library_ms']} card={card}")
    return rec


def phase_timing(torch, dev, docs, card: str, int_rate: float) -> dict:
    """B1, B2 and B5 at the engine's shapes (at its one-row bucket too) →
    {"main": {kernel: record at the widest lane, 64 rows},
    "shapes": {lane or "rows=1 lane=L": {kernel: record}}}."""
    import torch.nn.functional as F
    from repro_torch.core.bbit import (packed_mask_width, packed_width,
                                       unpack_codes_torch)
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import fused_encode as fe

    a, b = MultiplyShiftHash.make(K, 1).params(dev)
    oa, ob = OPHHash.make(K, 1).params(dev)
    table = (0.01 * torch.randn((K, 1 << B, 1),
                                generator=torch.Generator().manual_seed(0))
             ).to(dev)
    w_bytes, e_bytes = packed_width(K, B), packed_mask_width(K)
    # the launch floor: a kernel that does no work, timed as every kernel
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), 500)
    print(f"timing: launch_floor_ms={floor} (torch.cuda._sleep(0), 500 "
          f"calls) card={card}")
    out = {}
    for lane in NNZ_BUCKETS:
        idx, nnz, total_nnz = lane_batch(torch, dev, docs, lane)
        check_timed(torch, fe, bl, table, idx, nnz, (a, b, oa, ob),
                    f"rows={ROWS} lane={lane}")
        rec = {}
        ms = time_ms(torch, lambda: fe.minhash_pack(idx, nnz, a, b, bits=B),
                     200)
        plain = time_ms(torch, lambda: fe.minhash_pack_plain(
            idx, nnz, a, b, bits=B), 3)
        bnd = bound(4 * total_nnz + 4 * ROWS + 8 * K + ROWS * w_bytes,
                    OPS_PER_MINHASH * K * total_nnz, int_rate)
        rec["minhash_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                   bound_by=bnd[1], library_ms=None)
        ms = time_ms(torch, lambda: fe.oph_pack(idx, nnz, oa, ob, k=K,
                                                bits=B), 200)
        plain = time_ms(torch, lambda: fe.oph_pack_plain(
            idx, nnz, oa, ob, k=K, bits=B), 10)
        bnd = bound(4 * total_nnz + 4 * ROWS + 8 + ROWS * (w_bytes + e_bytes),
                    OPS_PER_OPH_HASH * total_nnz, int_rate)
        rec["oph_pack"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                               bound_by=bnd[1], library_ms=None)

        packed, _ = fe.oph_pack(idx, nnz, oa, ob, k=K, bits=B)
        codes = unpack_codes_torch(packed, K, B)
        flat = torch.arange(K, device=dev)[None, :] * (1 << B) + codes
        touched = int(torch.unique(flat).numel())
        ms = time_ms(torch, lambda: bl.bbit_linear_packed_fwd(
            packed, table, k=K, bits=B), 500)
        plain = time_ms(torch, lambda: bl.bbit_linear_packed_fwd_plain(
            packed, table, k=K, bits=B), 50)
        weight2d = table.view(K * (1 << B), 1)
        lib = time_ms(torch, lambda: F.embedding_bag(flat, weight2d,
                                                     mode="sum"), 500)
        bnd = bound(ROWS * w_bytes + 4 * touched + 4 * ROWS, ROWS * K,
                    PEAK_F32_OPS_PER_S)
        rec["bbit_linear_packed_fwd"] = dict(ms=ms, plain_ms=plain,
                                             bound_ms=bnd[0],
                                             bound_by=bnd[1],
                                             library_ms=lib)
        for name, r in rec.items():
            print(f"timing: {name} rows={ROWS} lane={lane} "
                  f"nnz_sum={total_nnz} ms={r['ms']} plain_ms="
                  f"{r['plain_ms']} bound_ms={r['bound_ms']} "
                  f"({r['bound_by']}) library_ms={r['library_ms']} "
                  f"card={card}")
        out[lane] = rec
        out[f"rows=1 lane={lane}"] = one_row(
            torch, F, fe, bl, table, idx[:1].contiguous(),
            nnz[:1].contiguous(), (a, b, oa, ob), int_rate, lane, card)
    return {"main": out[NNZ_BUCKETS[-1]], "shapes": out,
            "launch_floor_ms": floor}


def phase_timing_train(torch, dev, data, paper, card: str,
                       int_rate: float) -> dict:
    """B6-B9 at the train phase's shapes, and B7/B8 at the paper fits'
    too, beside their plain versions, one-call yardsticks and bounds →
    {"main": {kernel: record at its main path's shape}, "shapes":
    {kernel: {shape: record}}}."""
    from repro_torch.core.bbit import (pack_codes, packed_mask_width,
                                       packed_width, unpack_codes_torch,
                                       unpack_mask_torch)
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data.hashed_dataset import _length_sorted_chunks
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import bbit_linear as bl
    from repro_torch.kernels import vw_sketch as vw
    import torch.nn.functional as F

    v = 1 << B
    codes_np = data["codes"][:TRAIN_ROWS].astype(np.int32)
    codes = torch.from_numpy(codes_np).to(dev)
    table = data["params"]["table"].detach().contiguous()
    n = codes.shape[0]
    dout = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n, 1)).astype(np.float32)).to(dev)
    flat = torch.arange(K, device=dev)[None, :] * v + codes.to(torch.int64)
    weight2d = table.view(K * v, 1)
    touched = int(torch.unique(flat).numel())
    out, main = {}, {}

    def record(name, shape, ms, plain, bnd, lib, is_main=True, **extra):
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                   library_ms=lib, **extra)
        out.setdefault(name, {})[shape] = rec
        if is_main:
            main[name] = rec
        more = "".join(f" {key}={val}" for key, val in extra.items())
        print(f"timing: {name} {shape} ms={ms}{more} plain_ms={plain} "
              f"bound_ms={bnd[0]} ({bnd[1]}) library_ms={lib} card={card}")

    shape = f"n={n} k={K} V={v} C=1"
    record("bbit_linear_fwd", shape,
           time_ms(torch, lambda: bl.bbit_linear_fwd(codes, table), 200),
           time_ms(torch, lambda: bl.bbit_linear_fwd_plain(codes, table), 20),
           bound(4 * n * K + 4 * touched + 4 * n, n * K, PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: F.embedding_bag(flat, weight2d,
                                                  mode="sum"), 200))
    w_rep = dout[:, 0].repeat_interleave(K)
    flat1 = flat.reshape(-1)
    record("bbit_linear_bwd_dw", shape,
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw(codes, dout, v), 200),
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw_plain(codes, dout, v),
                   20),
           bound(4 * n * K + 4 * n + 4 * K * v, n * K, PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: torch.bincount(flat1, weights=w_rep,
                                                 minlength=K * v), 200),
           plan_ms=time_ms(torch, lambda: bl.bbit_linear_dw_plan(codes, v),
                           20))
    # the paper fits' shape: k=500 codes into a (500, 65536, 1) table
    pv = 1 << PAPER_B
    pcodes = torch.from_numpy(
        paper["codes"][:TRAIN_ROWS].astype(np.int32)).to(dev)
    ptable = paper["params"]["table"].detach().contiguous()
    pflat = (torch.arange(PAPER_K, device=dev)[None, :] * pv
             + pcodes.to(torch.int64))
    pweight = ptable.view(PAPER_K * pv, 1)
    ptouched = int(torch.unique(pflat).numel())
    pflat1 = pflat.reshape(-1)
    pw_rep = dout[:, 0].repeat_interleave(PAPER_K)
    shape = f"n={n} k={PAPER_K} V={pv} C=1"
    record("bbit_linear_fwd", shape,
           time_ms(torch, lambda: bl.bbit_linear_fwd(pcodes, ptable), 50),
           time_ms(torch, lambda: bl.bbit_linear_fwd_plain(pcodes, ptable),
                   10),
           bound(4 * n * PAPER_K + 4 * ptouched + 4 * n, n * PAPER_K,
                 PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: F.embedding_bag(pflat, pweight,
                                                  mode="sum"), 50),
           is_main=False)
    record("bbit_linear_bwd_dw", shape,
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw(pcodes, dout, pv),
                   50),
           time_ms(torch, lambda: bl.bbit_linear_bwd_dw_plain(
               pcodes, dout, pv), 10),
           bound(4 * n * PAPER_K + 4 * n + 4 * PAPER_K * pv, n * PAPER_K,
                 PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: torch.bincount(
               pflat1, weights=pw_rep, minlength=PAPER_K * pv), 20),
           is_main=False,
           plan_ms=time_ms(torch, lambda: bl.bbit_linear_dw_plan(pcodes, pv),
                           10))
    del pcodes, pflat, pflat1, pw_rep
    torch.cuda.empty_cache()
    for rows_n in (STREAM_BATCH, TRAIN_ROWS):
        packed = torch.from_numpy(pack_codes(
            codes_np[:rows_n].astype(np.uint16), B)).to(dev)
        d = dout[:rows_n].contiguous()
        f1 = flat[:rows_n].reshape(-1)
        wr = d[:, 0].repeat_interleave(K)
        record("bbit_linear_packed_bwd_dw", f"n={rows_n} k={K} V={v} C=1",
               time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw(
                   packed, d, v, k=K, bits=B), 200),
               time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw_plain(
                   packed, d, v, k=K, bits=B), 20),
               bound(rows_n * packed_width(K, B) + 4 * rows_n + 4 * K * v,
                     rows_n * K, PEAK_F32_OPS_PER_S),
               time_ms(torch, lambda: torch.bincount(f1, weights=wr,
                                                     minlength=K * v), 200),
               is_main=rows_n == STREAM_BATCH)
    # B6 with the oph_zero empty mask on the stream batch's own encode (the
    # packed gradient's input); a dropped bin goes past the table in bincount
    idx, nnz = pad_rows(data["rows"][:STREAM_BATCH])
    packed, empty = make_scheme("oph_zero", K, HASH_SEED).encode_packed(
        torch.from_numpy(idx).to(dev), torch.from_numpy(nnz).to(dev), B)
    d = dout[:STREAM_BATCH].contiguous()
    kw = dict(k=K, bits=B, empty=empty)
    f1 = torch.where(unpack_mask_torch(empty, K), K * v,
                     torch.arange(K, device=dev)[None, :] * v
                     + unpack_codes_torch(packed, K, B)).reshape(-1)
    wr = d[:, 0].repeat_interleave(K)
    record("bbit_linear_packed_bwd_dw",
           f"n={STREAM_BATCH} k={K} V={v} C=1 oph_zero mask",
           time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw(
               packed, d, v, **kw), 200),
           time_ms(torch, lambda: bl.bbit_linear_packed_bwd_dw_plain(
               packed, d, v, **kw), 20),
           bound(STREAM_BATCH * (packed_width(K, B) + packed_mask_width(K))
                 + 4 * STREAM_BATCH + 4 * K * v,
                 int((~unpack_mask_torch(empty, K)).sum()),
                 PEAK_F32_OPS_PER_S),
           time_ms(torch, lambda: torch.bincount(f1, weights=wr,
                                                 minlength=K * v + 1), 200),
           is_main=False)
    # B9 on the middle chunk of the corpus (the main-path record) and on
    # the widest full one (256 rows of 4,182-4,245 ids), where a row's
    # threads walk the most ids
    rows = data["rows"]
    chunks = list(_length_sorted_chunks(rows, VW_CHUNK))
    widest = [c for c in chunks if len(c) == VW_CHUNK][-1]
    for sel, mid in ((chunks[len(chunks) // 2], True), (widest, False)):
        idx, nnz = pad_rows([rows[i] for i in sel])
        total_nnz = int(nnz.sum())
        idx = torch.from_numpy(idx).to(dev)
        nnz = torch.from_numpy(nnz).to(dev)
        ones = torch.ones(idx.shape, dtype=torch.float32, device=dev)
        for m in (VW_EQUAL, VW_WIDE):
            record("vw_sketch", f"rows={len(sel)} nnz_sum={total_nnz} "
                   f"pad={idx.shape[1]} m={m}",
                   time_ms(torch, lambda: vw.vw_sketch(idx, ones, nnz, m,
                                                       seed=VW_SEED), 200),
                   time_ms(torch, lambda: vw.vw_sketch_plain(
                       idx, ones, nnz, m, seed=VW_SEED), 20),
                   bound(8 * total_nnz + 4 * len(sel) + 4 * len(sel) * m,
                         OPS_PER_VW_ID * total_nnz, int_rate),
                   None, is_main=mid and m == VW_WIDE)
    return {"main": main, "shapes": out}


def phase_timing_raw(torch, dev, rows, search: dict, card: str,
                     int_rate: float) -> dict:
    """B3 (k=500 and 256) and B4 (k=256) on the widest full chunk of
    ``preprocess_rows``' own, B10 over a typical query's candidates and
    over the whole index → {"main": {kernel: record at its main path's
    shape}, "shapes": {kernel: {shape: record}}}."""
    from repro_torch.core.oph import OPHHash
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.kernels import hamming as hd
    from repro_torch.kernels import minhash as mh
    from repro_torch.kernels import oph as oph_k

    sel, idx, nnz, total = raw_chunk(torch, dev, rows)
    n = len(sel)
    out, main = {}, {}

    def record(name, shape, ms, plain, bnd, is_main):
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                   library_ms=None)
        out.setdefault(name, {})[shape] = rec
        if is_main:
            main[name] = rec
        print(f"timing: {name} {shape} ms={ms} plain_ms={plain} bound_ms="
              f"{bnd[0]} ({bnd[1]}) library_ms=None card={card}")

    for k in (PAPER_K, K):
        a, b = MultiplyShiftHash.make(k, HASH_SEED).params(dev)
        record("minhash", f"rows={n} pad={idx.shape[1]} nnz_sum={total} "
               f"k={k}",
               time_ms(torch, lambda: mh.minhash(idx, nnz, a, b), 20),
               time_ms(torch, lambda: mh.minhash_plain(idx, nnz, a, b), 1,
                       warmup=1),
               bound(4 * total + 4 * n + 8 * k + 4 * n * k,
                     OPS_PER_MINHASH * k * total, int_rate),
               is_main=k == PAPER_K)
        torch.cuda.empty_cache()
    oa, ob = OPHHash.make(K, HASH_SEED).params(dev)
    record("oph", f"rows={n} pad={idx.shape[1]} nnz_sum={total} k={K}",
           time_ms(torch, lambda: oph_k.oph(idx, nnz, oa, ob, k=K), 200),
           time_ms(torch, lambda: oph_k.oph_plain(idx, nnz, oa, ob, k=K),
                   5),
           bound(4 * total + 4 * n + 8 + 4 * n * K,
                 OPS_PER_OPH_HASH * total, int_rate), is_main=True)
    q = search["query"]
    for cands, is_main in ((search["cands"], True), (search["table"], False)):
        rn, w = cands.shape
        record("hamming_distance", f"n={rn} w={w}",
               time_ms(torch, lambda: hd.hamming_distance(q, cands), 500),
               time_ms(torch, lambda: hd.hamming_distance_plain(q, cands),
                       50),
               bound(rn * w + w + 4 * rn,
                     OPS_PER_HAMMING_WORD * rn * ((w + 3) // 4), int_rate),
               is_main=is_main)
    return {"main": main, "shapes": out}


# ---------------------------------------------------------------------------
def b1_every_b(torch, dev, rows, card: str, int_rate: float) -> dict:
    """B1 at b whose codes straddle bytes (3, 6, 12, 16) beside today's
    b=8: at the engine's 64 rows x 8,192 ids (k=256) and at a 1,024-row
    chunk of the train corpus (k=500, the paper's), each held to its
    plain version byte for byte and timed → {shape: {b: record}}."""
    from repro_torch.core.bbit import packed_width
    from repro_torch.core.universal_hash import MultiplyShiftHash
    from repro_torch.data.packing import pad_rows
    from repro_torch.kernels import fused_encode as fe
    rng = np.random.default_rng(3)
    m = NNZ_BUCKETS[-1]
    eng_idx = torch.from_numpy(
        rng.integers(0, 1 << 31, size=(ROWS, m)).astype(np.int32)).to(dev)
    eng_nnz_np = rng.integers(1, m + 1, size=ROWS).astype(np.int32)
    eng_nnz_np[:3] = [0, 3, m]
    idx_c, nnz_c = pad_rows(rows[:PREPROCESS_CHUNK], pad_to_multiple=1)
    shapes = {f"rows={ROWS} lane={m} k={K}": (
                  eng_idx, torch.from_numpy(eng_nnz_np).to(dev), K),
              f"rows={PREPROCESS_CHUNK} chunk k={PAPER_K}": (
                  torch.from_numpy(idx_c).to(dev),
                  torch.from_numpy(nnz_c).to(dev), PAPER_K)}
    out = {}
    for where, (idx, nnz, k) in shapes.items():
        a, b = MultiplyShiftHash.make(k, 0).params(dev)
        total_nnz = int(nnz.clamp(0, idx.shape[1]).sum())
        out[where] = {}
        for bits in (8, 3, 6, 12, 16):
            got = fe.minhash_pack(idx, nnz, a, b, bits=bits)
            want = fe.minhash_pack_plain(idx, nnz, a, b, bits=bits)
            if int_err(torch, got, want):
                fail(f"minhash_pack b={bits} at {where} differs from its "
                     "plain version")
            ms = time_ms(torch, lambda: fe.minhash_pack(idx, nnz, a, b,
                                                        bits=bits), 50)
            plain = time_ms(torch, lambda: fe.minhash_pack_plain(
                idx, nnz, a, b, bits=bits), 2, warmup=1)
            n = idx.shape[0]
            bnd = bound(4 * total_nnz + 4 * n + 8 * k
                        + n * packed_width(k, bits),
                        OPS_PER_MINHASH * k * total_nnz, int_rate)
            out[where][bits] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                    bound_by=bnd[1], library_ms=None)
            print(f"linear: minhash_pack b={bits} {where} "
                  f"nnz_sum={total_nnz}: bytes equal, ms={ms} "
                  f"plain_ms={plain} bound_ms={bnd[0]} ({bnd[1]}) "
                  f"card={card}")
    return out


def phase_linear(torch, dev, card: str, data: dict, int_rate: float) -> dict:
    """launch/train.py --mode linear in process at configs/rcv1_bbit.py's
    k=500, b=16 on the train phase's corpus; build/chip_smoke_linear is
    removed after."""
    work = os.path.join(ROOT, "build", "chip_smoke_linear")
    shutil.rmtree(work, ignore_errors=True)
    try:
        return linear_in(torch, dev, card, data, work, int_rate)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def linear_args(work: str, **over):
    kw = dict(workdir=work, n_docs=TRAIN_DOCS, k=PAPER_K, b=PAPER_B,
              steps=LINEAR_STEPS, batch_size=LINEAR_BATCH, lr=1e-2,
              seed=LINEAR_SEED, ckpt_every=LINEAR_CKPT_EVERY, fail_at=None,
              device="cuda")
    kw.update(over)
    return argparse.Namespace(**kw)


def quiet(fn, *args):
    """fn(*args) with its standard output kept → (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def linear_in(torch, dev, card: str, data: dict, work: str,
              int_rate: float) -> dict:
    from repro_torch.configs.rcv1_bbit import CONFIG as PAPER
    from repro_torch.data.hashed_dataset import preprocess_and_save
    from repro_torch.kernels import ops
    from repro_torch.launch import fsck
    from repro_torch.launch import train as launch_train
    from repro_torch.train.metrics import trees_bitwise_equal

    if (PAPER.k, PAPER.b) != (PAPER_K, PAPER_B):
        fail("configs/rcv1_bbit.py is not at k=500, b=16")
    rows, labels = data["rows"], data["labels"]
    main_dir = os.path.join(work, "main")
    hashed = os.path.join(main_dir, "hashed")

    # the main path: the archive run_linear writes (B1 at b=16), then its
    # AdamW steps (B7 forward and B8 dW every step)
    ops.reset_counts()
    t0 = time.perf_counter()
    stats = preprocess_and_save(hashed, rows, labels, k=PAPER_K, b=PAPER_B,
                                seed=LINEAR_SEED, n_shards=4, device=dev)
    t_hash = time.perf_counter() - t0
    enc_counts = ops.counts()
    t0 = time.perf_counter()
    res, text = quiet(launch_train.run_linear, linear_args(main_dir))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    counts = ops.counts()
    print(f"linear: {text.strip()}")
    want = {"minhash_pack": -(-TRAIN_DOCS // PREPROCESS_CHUNK),
            "bbit_linear_fwd": LINEAR_STEPS + 1,
            "bbit_linear_bwd_dw": LINEAR_STEPS}
    print(f"linear: k={PAPER_K} b={PAPER_B} {TRAIN_DOCS} docs hashed in "
          f"{t_hash:.3f} s ({stats['mnnz_per_s']:.1f} M nnz/s), "
          f"{LINEAR_STEPS} steps of {LINEAR_BATCH} in {t_fit:.3f} s "
          f"(load, steps, checkpoints, test forward) test_acc="
          f"{res['test_acc']:.4f} final_loss={res['final_loss']:.4f} "
          f"counts={json.dumps({n: counts[n] for n in want})} card={card}")
    if enc_counts["minhash_pack"] != want["minhash_pack"]:
        fail(f"the archive took {enc_counts['minhash_pack']} B1 launches, "
             f"not {want['minhash_pack']}")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"linear phase: {name} launched {counts[name]} times, "
                 f"not {n}")
    plain = {n: v for n, v in counts.items() if n.endswith("_plain") and v}
    if plain:
        fail(f"linear phase ran plain versions on the card: {plain}")
    if not res["test_acc"] > 0.9:
        fail(f"linear phase test accuracy {res['test_acc']} <= 0.9")

    # the archive: launch/fsck.py passes it; its bytes equal the CPU's on
    # the first documents (the CPU's plain B1 takes seconds a thousand
    # documents at k=500)
    report, text = quiet(fsck.fsck_archive, hashed)
    if report["verified"] != 4 or report["corrupt"]:
        fail(f"fsck of the linear archive: {report}")
    n_cmp = LINEAR_CPU_DOCS
    for name in ("card", "cpu"):
        preprocess_and_save(os.path.join(work, f"cmp_{name}"), rows[:n_cmp],
                            labels[:n_cmp], k=PAPER_K, b=PAPER_B,
                            seed=LINEAR_SEED, n_shards=4,
                            device=dev if name == "card" else "cpu")
    for f in sorted(os.listdir(os.path.join(work, "cmp_cpu"))):
        if f.endswith(".npy") and (
                open(os.path.join(work, "cmp_card", f), "rb").read()
                != open(os.path.join(work, "cmp_cpu", f), "rb").read()):
            fail(f"linear archive file {f} differs between card and CPU")
    print(f"linear: fsck {report['verified']}/4 shards verified; the "
          f"first {n_cmp} documents' archive byte-equal card vs CPU")

    # --fail-at: a crash after a checkpoint, a rerun that resumes from it
    # and ends on the uninterrupted run's bits
    crash_dir = os.path.join(work, "crash")
    shutil.copytree(hashed, os.path.join(crash_dir, "hashed"))
    try:
        quiet(launch_train.run_linear,
              linear_args(crash_dir, fail_at=LINEAR_FAIL_AT))
        fail("--fail-at did not fail")
    except RuntimeError as e:
        if f"injected failure at step {LINEAR_FAIL_AT}" not in str(e):
            raise
    again, text = quiet(launch_train.run_linear, linear_args(crash_dir))
    resumed = (LINEAR_FAIL_AT // LINEAR_CKPT_EVERY) * LINEAR_CKPT_EVERY
    if f"resumed from step {resumed}" not in text:
        fail(f"the rerun did not resume from step {resumed}: {text}")
    same = (trees_bitwise_equal(again["params"], res["params"])
            and again["losses"] == res["losses"][resumed:])
    print(f"linear: crash at step {LINEAR_FAIL_AT}, resumed from step "
          f"{resumed}: params and losses bitwise equal={same}")
    if not same:
        fail("the resumed linear run differs from the uninterrupted one")

    # the same first steps on the CPU: AdamW params allclose (the
    # streaming tests' 1e-4 / 1e-5), losses too
    short = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        d = os.path.join(work, f"short_{name}")
        shutil.copytree(hashed, os.path.join(d, "hashed"))
        t0 = time.perf_counter()
        short[name], _ = quiet(launch_train.run_linear, linear_args(
            d, steps=LINEAR_CPU_STEPS, device=device))
        short[name]["seconds"] = time.perf_counter() - t0
    worst = 0.0
    for pname in ("table", "bias"):
        got = short["card"]["params"][pname].cpu()
        want_p = short["cpu"]["params"][pname]
        worst = max(worst, float((got - want_p).abs().max()))
        if not torch.allclose(got, want_p, **STREAM_CPU_TOL):
            fail(f"linear {pname} after {LINEAR_CPU_STEPS} steps: card vs "
                 f"CPU max_abs_err={float((got - want_p).abs().max())}")
    if not np.allclose(short["card"]["losses"], short["cpu"]["losses"],
                       **STREAM_CPU_TOL):
        fail("linear losses differ between card and CPU")
    if short["card"]["losses"] != res["losses"][:LINEAR_CPU_STEPS]:
        fail("the short card run's losses differ from the main run's")
    print(f"linear: {LINEAR_CPU_STEPS} steps card vs CPU: params allclose "
          f"{STREAM_CPU_TOL} (max_abs_err={worst}), losses allclose; "
          f"seconds card={short['card']['seconds']:.3f} "
          f"cpu={short['cpu']['seconds']:.3f}")

    every_b = b1_every_b(torch, dev, rows, card, int_rate)
    return {"counts": counts, "encode_counts": enc_counts,
            "test_acc": res["test_acc"], "final_loss": res["final_loss"],
            "seconds_hashing": t_hash, "seconds_fit": t_fit,
            "cpu_max_abs_err": worst, "b1_every_b": every_b}


def phase_calibrate(torch, dev, card: str, data: dict) -> dict:
    """launch/calibrate.py under a small budget, the profile loaded and an
    engine built from it against the static grid's; the profile file
    lives under build/ and is removed after."""
    from repro_torch import perf
    from repro_torch.configs.rcv1_oph import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch import calibrate as launch_cal
    from repro_torch.models.linear import init_bbit_linear
    from repro_torch.serving import HashedClassifierEngine

    work = os.path.join(ROOT, "build", "chip_smoke_calibrate")
    shutil.rmtree(work, ignore_errors=True)
    path = os.path.join(work, "profile.json")
    perf.reset()
    try:
        ops.reset_counts()
        t0 = time.perf_counter()
        rc, text = quiet(launch_cal.main, [
            "--out", path, "--budget-s", str(CALIBRATE_BUDGET_S),
            "--device", "cuda"])
        t_cal = time.perf_counter() - t0
        cal_counts = ops.counts()
        table = perf.CostTable.load(path)
        fp = table.fingerprint
        if rc != 0 or (fp.get("device_kind"), fp.get("device_count"),
                       fp.get("torch")) != (torch.cuda.get_device_name(0),
                                            torch.cuda.device_count(),
                                            torch.__version__):
            fail(f"calibration: rc={rc} fingerprint {fp}")
        per_op = {}
        for key in table.entries:
            op, impl, _ = key.split("|", 2)
            per_op.setdefault(op, set()).add(impl)
        print(f"calibrate: {len(table.entries)} entries in {t_cal:.2f} s "
              f"(budget {CALIBRATE_BUDGET_S} s) fingerprint "
              f"{perf.fingerprint_key(fp)!r} arms "
              f"{json.dumps({o: sorted(i) for o, i in per_op.items()})}")
        if any(impl == "plain" for impls in per_op.values()
               for impl in impls):
            fail("calibration timed a plain version on the card")
        if not perf.maybe_load_profile(path):
            fail("the card's own profile did not load")

        cfg = CONFIG.linear_config()
        params = init_bbit_linear(cfg, torch.Generator().manual_seed(7),
                                  device=dev)
        docs = data["rows"][TRAIN_ROWS:TRAIN_ROWS + CALIBRATE_DOCS]
        lanes = tuple(CONFIG.calibrate_nnz_buckets)
        kw = dict(scheme=CONFIG.scheme, device=dev,
                  max_batch=CONFIG.calibrate_max_batch, nnz_buckets=lanes,
                  seed=HASH_SEED)
        ops.reset_counts()
        hits0 = perf.dispatch_report()["hits"]
        with HashedClassifierEngine(params, cfg, row_buckets=None,
                                    **kw) as eng:
            suggested = eng.score_docs(docs)
            futs = eng.submit_many(docs)
            eng.flush()
            served = np.asarray([f.result(timeout=SERVE_WAIT_S)
                                 for f in futs], np.float32)
            st = eng.stats()
            rate_profile = serve_rate(eng, docs)
        counts = ops.counts()
        static_grid = tuple(1 << i for i in range(
            CONFIG.calibrate_max_batch.bit_length()))
        with HashedClassifierEngine(params, cfg, row_buckets=static_grid,
                                    **kw) as eng:
            static = eng.score_docs(docs)
            rate_static = serve_rate(eng, docs)
        bitwise = bool(np.array_equal(suggested, static))
        err = float(np.abs(suggested - static).max())
        print(f"calibrate: engine from the profile: lane_row_buckets="
              f"{json.dumps(st['lane_row_buckets'])} lane_caps="
              f"{json.dumps(st['lane_caps'])} (static grid "
              f"{list(static_grid)}); scores vs the static grid's "
              f"bitwise={bitwise} max_abs_err={err}; dispatch hits="
              f"{st['dispatch']['hits'] - hits0} fallbacks="
              f"{st['dispatch']['fallbacks']} table="
              f"{st['dispatch']['table_version']}")
        print(f"calibrate: serve pass over {len(docs)} held-out docs "
              f"(an observation, held to no limit): profile grid "
              f"{rate_profile['median']:.1f} docs/s (p10 "
              f"{rate_profile['p10']:.1f}, p90 {rate_profile['p90']:.1f}), "
              f"static grid {rate_static['median']:.1f} docs/s (p10 "
              f"{rate_static['p10']:.1f}, p90 {rate_static['p90']:.1f}) "
              f"card={card}")
        if not np.array_equal(served, suggested):
            fail("the profile engine's submit_many differs from score_docs")
        if not (bitwise or np.allclose(suggested, static, rtol=1e-6,
                                       atol=1e-6)):
            fail(f"profile engine scores differ from the static grid's by "
                 f"{err}")
        if not st["dispatch"]["profile_loaded"] or \
                st["dispatch"]["hits"] - hits0 <= 0:
            fail(f"the engine read no profile hits: {st['dispatch']}")
        plain = {n: v for c in (counts, cal_counts) for n, v in c.items()
                 if n.endswith("_plain") and v}
        if plain:
            fail(f"calibrate phase ran plain versions on the card: {plain}")
        if counts["oph_pack"] < 1 or counts["bbit_linear_packed_fwd"] < 1:
            fail(f"the profile engine launched no B2/B5: {counts}")
        return {"counts": counts, "calibrate_counts": cal_counts,
                "entries": len(table.entries), "seconds": t_cal,
                "lane_row_buckets": st["lane_row_buckets"],
                "lane_caps": st["lane_caps"], "bitwise": bitwise,
                "max_abs_err": err, "hits": st["dispatch"]["hits"] - hits0,
                "rate_profile": rate_profile, "rate_static": rate_static}
    finally:
        perf.reset()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# the lm phase: the LM zoo (ROADMAP A6a)
# ---------------------------------------------------------------------------
def _lm_batch(torch, cfg, batch: int, seq: int, seed: int, dev) -> dict:
    """tests/_lm_parity.py's batch: tokens and targets uniform in
    [0, vocab), the modality's float input N(0, 1), from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)),
           "targets": rng.integers(0, cfg.vocab, (batch, seq))}
    extra = {"vision_stub": "vision_embeds",
             "audio_stub": "frames"}.get(cfg.frontend)
    if extra:
        out[extra] = rng.normal(size=(batch, cfg.frontend_len, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.int32 if k in ("tokens",
                                                           "targets")
                                         else np.float32)).to(dev)
            for k, v in out.items()}


def _grown(api, cache, batch: int, max_len: int, dev):
    """A prefill cache grown into init_cache(batch, max_len)."""
    from repro_torch.serving.engine import grow_cache
    return grow_cache(api.init_cache(batch, max_len, device=dev), cache)


def _decode_bytes(cfg, params, cache, batch: int, valid_len: float) -> float:
    """The bytes one decode step must move: every param but the
    embedding once, the embedding rows of the batch's tokens (one each,
    or hash_k with embedding="bbit_hash"), the KV cache's first
    ``valid_len`` positions read and one position written, and the
    logits written."""
    from repro_torch import tree
    el = params["lm_head"].element_size()
    body = sum(t.numel() * t.element_size() for t in tree.leaves(params)) \
        - sum(t.numel() * t.element_size() for t in params["embed"].values())
    rows = cfg.hash_k if cfg.embedding == "bbit_hash" else 1
    kv_per_pos = sum(t.numel() * t.element_size() / t.shape[2]
                     for t in cache.values())
    return (body + batch * rows * cfg.d_model * el
            + kv_per_pos * (valid_len + 1) + batch * cfg.vocab * el)


def _wall_ms(torch, fn, reps: int = 3) -> float:
    """Median wall time of ``fn`` (synchronized), after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lm_full(torch, dev, card: str, embedding: str) -> dict:
    """internlm2-1.8b as registered, with the dense or the b-bit hashed
    embedding: the loss, prefill, greedy_generate, decode held to a fresh
    prefill, and the numbers."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import lm_example_stream
    from repro_torch.models.api import get_model_api
    from repro_torch.serving import greedy_generate

    cfg = dataclasses.replace(get_config(LM_ARCH), embedding=embedding)
    api = get_model_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    from repro_torch import tree
    leaves = tree.leaves(params)
    n_params = sum(t.numel() for t in leaves)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    emb = params["embed"]
    emb_shape = {k: list(v.shape) for k, v in emb.items()}
    emb_n = sum(v.numel() for v in emb.values())
    _, toks, tgts = next(lm_example_stream(LM_BATCH, LM_PROMPT, cfg.vocab,
                                           seed=0))
    prompt = torch.from_numpy(toks).to(dev)
    with torch.no_grad():
        loss = float(api.loss_fn(params, {
            "tokens": prompt, "targets": torch.from_numpy(tgts).to(dev)}))
        prefill_ms = _wall_ms(torch, lambda: api.prefill(
            params, {"tokens": prompt}))
        # decode held to a fresh prefill over the prompt and the tokens so
        # far, at the first LM_SELF_CHECKS generated positions
        logits, cache = api.prefill(params, {"tokens": prompt})
        cache = _grown(api, cache, LM_BATCH, LM_PROMPT + LM_NEW, dev)
        seq = torch.cat([prompt, torch.argmax(logits, -1)[:, None].to(
            torch.int32)], 1)
        self_err, self_scale = 0.0, 0.0
        for t in range(1, LM_SELF_CHECKS + 1):
            dec, cache = api.decode_step(params, {"token": seq[:, -1:]},
                                         cache, LM_PROMPT + t - 1)
            fresh, _ = api.prefill(params, {"tokens": seq})
            self_err = max(self_err, float((dec.float() - fresh.float())
                                           .abs().max()))
            self_scale = max(self_scale, float(fresh.float().abs().max()))
            seq = torch.cat([seq, torch.argmax(dec, -1)[:, None].to(
                torch.int32)], 1)
        # the decode loop alone, timed: the same steps as greedy_generate
        cache = _grown(api, api.prefill(params, {"tokens": prompt})[1],
                       LM_BATCH, LM_PROMPT + LM_NEW, dev)
        nxt = seq[:, LM_PROMPT:LM_PROMPT + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, LM_NEW):
            dec, cache = api.decode_step(params, {"token": nxt}, cache,
                                         LM_PROMPT + t - 1)
            nxt = torch.argmax(dec, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (LM_NEW - 1)
        # the timed steps attend over LM_PROMPT + 1 .. LM_PROMPT + LM_NEW
        # - 1 positions: their bound at the mean
        step_bytes = _decode_bytes(cfg, params, cache, LM_BATCH,
                                   LM_PROMPT + LM_NEW / 2)
        bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
        # under torch.profiler: one prefill, and LM_PROFILE_STEPS decode
        # steps (the trace of a whole generate takes longer to read back
        # than to run)
        _, prof_pre = profiled(torch, lambda: api.prefill(
            params, {"tokens": prompt}))

        def steps():
            tok = nxt
            for t in range(LM_PROFILE_STEPS):
                dec, _ = api.decode_step(params, {"token": tok}, cache,
                                         LM_PROMPT + LM_NEW - 1)
                tok = torch.argmax(dec, -1)[:, None].to(torch.int32)

        _, prof = profiled(torch, steps)
    t0 = time.perf_counter()
    out = greedy_generate(api, params, toks, LM_NEW, device=dev)
    generate_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # the device's busy share of an unprofiled step (the profiler about
    # doubles a step's wall time), and of the profiled steps
    busy = prof["device_ms"] / LM_PROFILE_STEPS / decode_ms
    busy_profiled = prof["device_ms"] / prof["wall_ms"]
    same = bool(np.array_equal(out[:, :LM_PROMPT + LM_SELF_CHECKS + 1],
                               seq.cpu().numpy()))
    tol = LM_BF16_SELF_TOL * max(self_scale, 1.0)
    rec = {"embedding": embedding, "n_params": n_params,
           "n_params_cfg": cfg.n_params(), "param_bytes": p_bytes,
           "embed_shape": emb_shape, "embed_params": emb_n,
           "init_s": init_s, "loss": loss, "ln_vocab": math.log(cfg.vocab),
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "tokens_per_s": LM_BATCH * 1e3 / decode_ms,
           "decode_bytes": step_bytes, "bound_ms": bound_ms,
           "generate_s": generate_s,
           "prefill_profiled": prof_pre, "decode_profiled": prof,
           "decode_device_ms": prof["device_ms"] / LM_PROFILE_STEPS,
           "busy": busy, "busy_profiled": busy_profiled,
           "peak_bytes": peak,
           "self_err": self_err, "self_scale": self_scale,
           "self_tol": tol, "tokens_match_manual_loop": same}
    print(f"lm: {LM_ARCH} {embedding} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, "
          f"{cfg.dtype}): {n_params} params ({p_bytes / 1e9:.4f} GB; "
          f"cfg.n_params() {cfg.n_params()}), embedding {emb_shape} = "
          f"{emb_n} params, init {init_s:.2f} s")
    print(f"lm: {embedding}: loss of a {LM_BATCH} x {LM_PROMPT} "
          f"lm_example_stream batch {loss:.4f} (ln vocab "
          f"{math.log(cfg.vocab):.4f}); decode vs fresh prefill over "
          f"{LM_SELF_CHECKS} positions max|diff| {self_err:.4g} (bound "
          f"{tol:.4g}, max|logit| {self_scale:.4g}); greedy tokens equal "
          f"the checked loop's: {same}")
    print(f"lm: {embedding}: prefill {LM_BATCH} x {LM_PROMPT} "
          f"{prefill_ms:.3f} ms (device {prof_pre['device_ms']:.3f} ms); "
          f"decode {decode_ms:.3f} ms a step ({LM_BATCH * 1e3 / decode_ms:.1f}"
          f" tokens/s at batch {LM_BATCH}; device "
          f"{prof['device_ms'] / LM_PROFILE_STEPS:.3f} ms a step over "
          f"{LM_PROFILE_STEPS} profiled steps, busy {busy:.4f} of the "
          f"unprofiled step, {busy_profiled:.4f} under the profiler) "
          f"against a bound of {bound_ms:.4f} ms ({step_bytes / 1e9:.4f} "
          f"GB a step / 3.35 TB/s); "
          f"greedy_generate of {LM_NEW} tokens {generate_s:.3f} s; peak "
          f"memory {peak / 2**30:.3f} GiB card={card}")
    print(f"lm: {embedding}: decode steps' top device ops (us) "
          f"{json.dumps(prof['top'][:5])}; top host ops (ms, calls) "
          f"{json.dumps(prof['host_top'][:5])}")
    if not math.isfinite(loss) or abs(loss - math.log(cfg.vocab)) > 1.0:
        fail(f"lm {embedding}: loss {loss} is not near ln(vocab)")
    if out.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            not np.array_equal(out[:, :LM_PROMPT], toks):
        fail(f"lm {embedding}: greedy_generate gave {out.shape}")
    if not (out[:, LM_PROMPT:] >= 0).all() or \
            not (out[:, LM_PROMPT:] < cfg.vocab).all():
        fail(f"lm {embedding}: tokens outside the vocabulary")
    if self_err > tol:
        fail(f"lm {embedding}: decode vs prefill {self_err} > {tol}")
    if not same:
        fail(f"lm {embedding}: greedy_generate's tokens differ from the "
             "checked loop's")
    del params, cache
    return rec


def _top2_margin(torch, logits, rows) -> float:
    top = torch.topk(logits.float()[rows], 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


def lm_reduced(torch, dev) -> dict:
    """Each architecture at reduced_config (float32), the card against
    the CPU on the same params and inputs: the loss, prefill's logits
    and cache, one decode step, greedy_generate of LM_REDUCED_NEW tokens
    (equal where the CPU's top-2 margin exceeds twice the logits'
    tolerance; after a tie the two sequences may part)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.archs import ALL_ARCHS
    from repro_torch.launch.smoke_configs import reduced_config
    from repro_torch.models.api import get_model_api
    from repro_torch.models.linear import full_float32_matmul
    from repro_torch.serving import greedy_generate

    cpu = torch.device("cpu")
    out = {}
    for arch in ALL_ARCHS:
        cfg = reduced_config(get_config(arch))
        api = get_model_api(cfg)
        p_cpu = api.init_params(torch.Generator().manual_seed(1),
                                device="cpu")
        p_dev = tree.tree_map(lambda t: t.to(dev), p_cpu)
        b_cpu = _lm_batch(torch, cfg, 2, LM_REDUCED_SEQ, 3, cpu)
        b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
        pre = [{k: v for k, v in b.items() if k != "targets"}
               for b in (b_cpu, b_dev)]
        res = []
        with torch.no_grad(), full_float32_matmul():
            for params, batch, pb, d in ((p_cpu, b_cpu, pre[0], cpu),
                                         (p_dev, b_dev, pre[1], dev)):
                loss = float(api.loss_fn(params, batch))
                logits, cache = api.prefill(params, pb)
                cache_l = [t.float().cpu() for t in tree.leaves(cache)]
                cache = _grown(api, cache, 2, LM_REDUCED_SEQ + 4, d)
                dec, _ = api.decode_step(
                    params, {"token": batch["tokens"][:, :1]}, cache,
                    LM_REDUCED_SEQ)
                extras = {k: v for k, v in pb.items() if k != "tokens"}
                toks = greedy_generate(api, params, pb["tokens"].cpu()
                                       .numpy(), LM_REDUCED_NEW,
                                       extras=extras, device=d)
                res.append((loss, logits.float().cpu(), cache_l,
                            dec.float().cpu(), toks))
            (l_c, lg_c, c_c, d_c, t_c), (l_d, lg_d, c_d, d_d, t_d) = res
            errs = {"loss_rel": abs(l_d - l_c) / abs(l_c),
                    "prefill": float((lg_d - lg_c).abs().max()),
                    "cache": max(float((a - b).abs().max())
                                 for a, b in zip(c_d, c_c)),
                    "decode": float((d_d - d_c).abs().max())}
            # greedy tokens: equal, or parted where the CPU's margin is a tie
            diff = np.argwhere(t_c != t_d)
            parted = None
            if len(diff):
                pos = int(diff[:, 1].min())
                rows = sorted({int(r) for r, c in diff if c == pos})
                ctx = {"tokens": torch.from_numpy(t_c[:, :pos])}
                ctx.update({k: v for k, v in pre[0].items()
                            if k != "tokens"})
                lg, _ = api.prefill(p_cpu, ctx)
                parted = {"position": pos, "rows": rows,
                          "cpu_margin": _top2_margin(torch, lg, rows)}
        out[arch] = dict(errs, parted=parted)
        bad = [k for k, lim in (("loss_rel", LM_LOSS_RTOL),
                                ("prefill", LM_LOGIT_ATOL),
                                ("cache", LM_LOGIT_ATOL),
                                ("decode", LM_LOGIT_ATOL))
               if not errs[k] <= lim]
        if parted is not None and \
                parted["cpu_margin"] > 2 * LM_LOGIT_ATOL:
            bad.append(f"greedy parted at {parted}")
        if bad:
            fail(f"lm reduced {arch}: card vs CPU {bad}: {errs}")
    worst = {k: max(v[k] for v in out.values())
             for k in ("loss_rel", "prefill", "cache", "decode")}
    parted = {a: v["parted"] for a, v in out.items() if v["parted"]}
    print(f"lm: ten archs at reduced_config, float32, card vs CPU (no "
          f"TF32): worst loss rel {worst['loss_rel']:.3g} (limit "
          f"{LM_LOSS_RTOL}), prefill logits {worst['prefill']:.3g}, cache "
          f"{worst['cache']:.3g}, decode {worst['decode']:.3g} (limit "
          f"{LM_LOGIT_ATOL}); greedy_generate of {LM_REDUCED_NEW} tokens "
          f"equal for {10 - len(parted)} of 10"
          + (f", parted at ties {json.dumps(parted)}" if parted else ""))
    return {"archs": out, "worst": worst}


def lm_microbatched(torch, dev) -> dict:
    """build_microbatched_train_step: LM_MICRO_STEPS AdamW steps at
    n_micro=LM_MICRO on reduced internlm2, the card against the CPU.
    AdamW's eps is 1e-4: at 1e-8 a gradient element at float32 noise
    level becomes a full step of the rounding's sign
    (tests/test_torch_lm_generate.py)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.lm_synth import lm_example_stream
    from repro_torch.launch.smoke_configs import reduced_config
    from repro_torch.models.api import get_model_api
    from repro_torch.models.linear import full_float32_matmul
    from repro_torch.optim.optimizers import AdamWConfig, adamw
    from repro_torch.train.steps import (build_microbatched_train_step,
                                         init_state)

    cfg = reduced_config(get_config(LM_ARCH))
    api = get_model_api(cfg)
    p_cpu = api.init_params(torch.Generator().manual_seed(2), device="cpu")
    runs = []
    for d in (torch.device("cpu"), dev):
        opt = adamw(1e-3, AdamWConfig(eps=1e-4))
        step = build_microbatched_train_step(
            lambda p, b: api.loss_fn(p, b), opt, LM_MICRO)
        state = init_state(tree.tree_map(lambda t: t.clone().to(d), p_cpu),
                           opt)
        losses = []
        stream = lm_example_stream(4, LM_REDUCED_SEQ, cfg.vocab, seed=4)
        with full_float32_matmul():
            for _, toks, tgts in (next(stream)
                                  for _ in range(LM_MICRO_STEPS)):
                state, loss = step(state, {
                    "tokens": torch.from_numpy(toks).to(d),
                    "targets": torch.from_numpy(tgts).to(d)})
                losses.append(float(loss))
        runs.append((losses, [t.cpu() for t in tree.leaves(state.params)]))
    (l_c, p_c), (l_d, p_d) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_d, l_c))
    err = max(float((a - b).abs().max()) for a, b in zip(p_d, p_c))
    print(f"lm: build_microbatched_train_step, {LM_MICRO_STEPS} AdamW steps "
          f"at n_micro={LM_MICRO} on reduced {LM_ARCH}, card vs CPU: "
          f"losses {[round(x, 6) for x in l_d]} (rel {loss_rel:.3g}), "
          f"params max|diff| {err:.3g} (limit {LM_MICRO_ATOL})")
    if loss_rel > LM_LOSS_RTOL or err > LM_MICRO_ATOL:
        fail(f"lm microbatched step: card vs CPU loss {loss_rel}, "
             f"params {err}")
    return {"losses": l_d, "loss_rel": loss_rel, "param_err": err}


def phase_lm(torch, dev, card: str) -> dict:
    """The LM zoo: internlm2-1.8b at full width and depth, dense and
    hashed; the ten architectures reduced, card vs CPU; the microbatched
    step.  No B-kernel and no plain version runs here."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    parts_s = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts_s[name] = round(time.perf_counter() - t0, 2)
        return out

    dense = part("dense", lm_full, torch, dev, card, "dense")
    hashed = part("bbit_hash", lm_full, torch, dev, card, "bbit_hash")
    reduced = part("reduced", lm_reduced, torch, dev)
    micro = part("microbatched", lm_microbatched, torch, dev)
    print(f"lm: parts (s): {json.dumps(parts_s)}")
    counts = {n: v for n, v in ops.counts().items() if v}
    if counts:
        fail(f"the lm phase launched kernels or plain versions: {counts}")
    torch.cuda.empty_cache()
    return {"dense": dense, "bbit_hash": hashed, "reduced": reduced,
            "microbatched": micro, "parts_s": parts_s}


def _predictions(card: str) -> dict:
    """The dry-run's predictions for the lm_mesh phase's one-rank cells,
    from a CPU subprocess (a fake one-rank world, meta shards): argument
    bytes and peak (arguments + the traced call's temporaries)."""
    code = (
        "import json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.mesh import fake_world, make_test_mesh\n"
        "from repro_torch.launch.shapes import CellPlan\n"
        "from repro_torch.models.api import get_model_api\n"
        "fake_world(1)\n"
        "mesh = make_test_mesh(1, 1)\n"
        f"api = get_model_api(get_config({LM_ARCH!r}))\n"
        "out = {}\n"
        f"for kind, b, s, n in (('prefill', {LM_BATCH}, {LM_PROMPT}, 1), "
        f"('decode', {LM_BATCH}, {LM_PROMPT + LM_NEW}, 1), "
        f"('train', {LM_MESH_TRAIN_BATCH}, {LM_PROMPT}, "
        f"{LM_MESH_MICRO})):\n"
        "    plan = CellPlan(arch='x', shape=kind, kind=kind, seq=s, "
        "global_batch=b, n_micro=n, b_local=b)\n"
        "    args, tr = dryrun.trace_cell(api, mesh, plan)\n"
        "    out[kind] = {'argument_bytes': args, 'temp_bytes': "
        "tr.temp_bytes, 'peak_bytes': args + tr.temp_bytes, "
        "'flops': tr.cost.flops, 'bytes': tr.cost.bytes, "
        "'dtensor_ops': tr.n_dtensor_ops, 'local_ops': tr.n_ops}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env)
    if proc.returncode != 0:
        fail(f"lm_mesh: the dry-run's prediction failed: "
             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _launcher(torch, module: str, args: list, card: str) -> dict:
    """``python -m repro_torch.launch.<module> --mode lm`` on the card, in
    a subprocess that must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           f"repro_torch.launch.{module}", "--mode", "lm",
                           *args], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"lm_mesh: launch/{module}.py --mode lm exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return {"stdout": proc.stdout.strip().splitlines()[-2:],
            "seconds": secs}


def _vocab_parallel_loss(api, mesh):
    """The mesh-free model's loss through the vocab-parallel
    cross-entropy (``transformer._mesh_xent``, a one-rank group): its
    plain logits wrapped as a DTensor on the one-rank ``mesh``, the loss
    handed back as a plain tensor.  Everything else is the mesh-free
    model's own arithmetic."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import shardings as sh
    from repro_torch.models import transformer as T
    lspec = sh.placements(mesh, sh.P("data", None, "model"))
    tspec = sh.placements(mesh, sh.P("data", None))

    def xent(lg, tg):
        with sh.implicit_replication():
            return T.xent_loss(
                DTensor.from_local(lg, mesh, lspec, run_check=False),
                DTensor.from_local(tg, mesh, tspec,
                                   run_check=False)).to_local()

    def loss(params, batch):
        return xent(T.forward_train(params, batch["tokens"], api.cfg),
                    batch["targets"])
    return xent, loss


def _xent_attribution(torch, api, params, batch, mesh, n_micro: int) -> dict:
    """Where the one-rank mesh step parts from the mesh-free step, before
    either moves the params: the gradient of the vocab-parallel
    cross-entropy against the gather one's on the same bfloat16 logits
    (the first microbatch's), and the mean gradient of the mesh-free
    model over the batch's microbatches through each: each leaf's
    largest gap over its largest element, and the elements that
    differ."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    xent, vp_loss = _vocab_parallel_loss(api, mesh)
    half = batch["tokens"].shape[0] // n_micro
    mb = [{k: v[i * half:(i + 1) * half] for k, v in batch.items()}
          for i in range(n_micro)]
    with torch.no_grad():
        lg = T.forward_train(params, mb[0]["tokens"], api.cfg)
    a = lg.detach().requires_grad_(True)
    ga, = torch.autograd.grad(T.xent_loss(a, mb[0]["targets"]), a)
    b = lg.detach().requires_grad_(True)
    gb, = torch.autograd.grad(xent(b, mb[0]["targets"]), b)
    rec = {"dlogits_differ": int((ga != gb).sum()),
           "dlogits_n": ga.numel(),
           "dlogits_err": float((ga.float() - gb.float()).abs().max()),
           "dlogits_scale": float(ga.float().abs().max())}
    del lg, a, ga, b, gb

    def mean_grad(loss_fn):
        gsum = [torch.zeros_like(p, dtype=torch.float32)
                for p in tree.leaves(params)]
        for m in mb:
            live = [p.detach().requires_grad_(True)
                    for p in tree.leaves(params)]
            with torch.enable_grad():
                g = torch.autograd.grad(
                    loss_fn(tree.unflatten(params, live), m), live)
            gsum = [s + x.to(torch.float32) for s, x in zip(gsum, g)]
            del g, live
        return [s / n_micro for s in gsum]

    g_plain = mean_grad(lambda p, m: api.loss_fn(p, m))
    g_vp = mean_grad(vp_loss)
    rec["grad_rel"] = max(float((x - y).abs().max())
                          / max(float(x.abs().max()), 1e-30)
                          for x, y in zip(g_plain, g_vp))
    rec["grad_differ"] = sum(int((x != y).sum())
                             for x, y in zip(g_plain, g_vp))
    rec["grad_n"] = sum(x.numel() for x in g_plain)
    return rec


def _train_state_gap(torch, state, state_h) -> dict:
    """The mesh step's state against a mesh-free step's after the same
    steps: the params' largest gap and the elements that differ; the
    first moments' largest gap over each leaf's largest |m|, and the
    elements that differ."""
    from repro_torch import tree
    gap = {"p_err": 0.0, "p_differ": 0, "m_rel": 0.0, "m_differ": 0,
           "n": 0}
    for n, p, p_h in zip(tree.paths(state_h.params),
                         tree.leaves(state.params),
                         tree.leaves(state_h.params)):
        d = (p.to_local().float() - p_h.float()).abs()
        gap["p_err"] = max(gap["p_err"], float(d.max()))
        gap["p_differ"] += int((d > 0).sum())
        gap["n"] += d.numel()
        m = state.opt_state["m"][n].to_local()
        m_h = state_h.opt_state["m"][n]
        gap["m_rel"] = max(gap["m_rel"], float((m - m_h).abs().max())
                           / max(float(m_h.abs().max()), 1e-30))
        gap["m_differ"] += int((m != m_h).sum())
    return gap


def phase_lm_mesh(torch, dev, card: str) -> dict:
    """The LM zoo through launch/steps.py on a one-rank NCCL DeviceMesh
    (data=1, model=1) on cuda:0: internlm2-1.8b as registered (the lm
    phase's params and prompt), build_prefill_step and 32 greedy steps of
    build_decode_step against the mesh-free model (tokens equal; a token
    that differs must sit at a tie of the two top logits within the
    decode bound), build_lm_train_step at full width against
    build_microbatched_train_step (params and first moments after each
    step against the mesh-free model trained through the same
    vocab-parallel cross-entropy; losses against the plain one's),
    build_linear_train_step at the
    paper's k=500, b=16 against the mesh-free AdamW step over B7/B8 (its
    own loss is a gather on local shards: no kernel), the dry-run's
    argument bytes (equal to those allocated) and peak (a ratio to
    max_memory_allocated), and both launchers' --mode lm."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.rcv1_bbit import PaperConfig
    from repro_torch.data.lm_synth import lm_example_stream
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.shapes import CellPlan
    from repro_torch.models.api import get_model_api
    from repro_torch.models.linear import BBitLinearConfig, bbit_logits
    from repro_torch.optim.optimizers import AdamWConfig, adamw
    from repro_torch.serving import greedy_generate
    from repro_torch.train.losses import mean_loss_fn
    from repro_torch.train.steps import (build_microbatched_train_step,
                                         build_train_step, init_state)

    total_memory = torch.cuda.get_device_properties(0).total_memory
    predicted = _predictions(card)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    rec = {"backend": str(dist.get_backend()),
           "total_memory": total_memory,
           "hbm_budget_equal": total_memory == dryrun.HBM_BUDGET_BYTES,
           "predicted": predicted}
    try:
        mesh = make_test_mesh(1, 1)
        if mesh.device_type != "cuda":
            fail(f"lm_mesh: the mesh is on {mesh.device_type}, not cuda")
        cfg = get_config(LM_ARCH)
        api = get_model_api(cfg)
        params = api.init_params(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
        _, toks, tgts = next(lm_example_stream(LM_BATCH, LM_PROMPT,
                                               cfg.vocab, seed=0))
        prompt = torch.from_numpy(toks).to(dev)
        # --- prefill and greedy decode ----------------------------------
        plan = CellPlan(arch=LM_ARCH, shape="prefill", kind="prefill",
                        seq=LM_PROMPT, global_batch=LM_BATCH, n_micro=1,
                        b_local=LM_BATCH)
        pstep, _, pp, _, bps = S.build_prefill_step(api, mesh, plan)
        dparams = S.shard_tree(params, pp, mesh)
        dprompt = S.shard_tree({"tokens": prompt}, bps, mesh)
        arg_real = {"prefill": S.local_bytes((dparams, dprompt))}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            lg_m, cache_m = pstep(dparams, dprompt)
            torch.cuda.synchronize()
            peak = {"prefill": torch.cuda.max_memory_allocated() - base
                    + arg_real["prefill"]}
            lg0, _ = api.prefill(params, {"tokens": prompt})
        lg_m = lg_m.full_tensor()
        scale = float(lg0.float().abs().max())
        tol = LM_BF16_SELF_TOL * max(scale, 1.0)
        prefill_err = float((lg_m.float() - lg0.float()).abs().max())
        prefill_ms = _wall_ms(torch, lambda: pstep(dparams, dprompt))
        prefill0_ms = _wall_ms(torch, lambda: api.prefill(
            params, {"tokens": prompt}))
        dplan = dataclasses.replace(plan, kind="decode", shape="decode",
                                    seq=LM_PROMPT + LM_NEW)
        dstep, _, (_, cps, _, dbps) = S.build_decode_step(api, mesh, dplan)
        grown = _grown(api, tree.tree_map(lambda t: t.full_tensor(),
                                          cache_m),
                       LM_BATCH, LM_PROMPT + LM_NEW, dev)
        dcache = S.shard_tree(grown, cps, mesh)
        want = greedy_generate(api, params, toks, LM_NEW, device=dev)
        nxt = torch.argmax(lg_m, -1)[:, None].to(torch.int32)
        got = [nxt]
        parted, margins = None, []
        arg_real["decode"] = S.local_bytes((dparams, dcache)) + 4 + \
            S.local_bytes(S.shard_tree({"token": nxt}, dbps, mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(1, LM_NEW):
                dec, dcache = dstep(dparams, dcache, LM_PROMPT + t - 1,
                                    S.shard_tree({"token": nxt}, dbps,
                                                 mesh))
                dec = dec.full_tensor()
                nxt = torch.argmax(dec, -1)[:, None].to(torch.int32)
                got.append(nxt)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (LM_NEW - 1)
        peak["decode"] = torch.cuda.max_memory_allocated() - base + \
            arg_real["decode"]
        got = torch.cat(got, 1).cpu().numpy()
        diff = np.argwhere(got != want[:, LM_PROMPT:])
        if len(diff):
            pos = int(diff[:, 1].min())
            rows = sorted({int(r) for r, c in diff if c == pos})
            ctx = torch.from_numpy(want[:, :LM_PROMPT + pos]).to(dev)
            with torch.no_grad():
                lg, _ = api.prefill(params, {"tokens": ctx})
            margin = _top2_margin(torch, lg, rows)
            parted = {"step": pos, "rows": rows, "top2_margin": margin}
            if margin > tol:
                fail(f"lm_mesh: greedy tokens part at step {pos} rows "
                     f"{rows} with a top-2 margin {margin} > {tol}")
        # the mesh-free decode step timed the same way
        cache0 = _grown(api, api.prefill(params, {"tokens": prompt})[1],
                        LM_BATCH, LM_PROMPT + LM_NEW, dev)
        nxt0 = torch.from_numpy(want[:, LM_PROMPT:LM_PROMPT + 1]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(1, LM_NEW):
                d0, cache0 = api.decode_step(params, {"token": nxt0},
                                             cache0, LM_PROMPT + t - 1)
                nxt0 = torch.argmax(d0, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        decode0_ms = (time.perf_counter() - t0) * 1e3 / (LM_NEW - 1)
        with torch.no_grad():
            tok = nxt.clone()

            def mesh_steps():
                for _ in range(LM_PROFILE_STEPS):
                    dstep(dparams, dcache, LM_PROMPT + LM_NEW - 1,
                          S.shard_tree({"token": tok}, dbps, mesh))

            def plain_steps():
                for _ in range(LM_PROFILE_STEPS):
                    api.decode_step(params, {"token": tok}, cache0,
                                    LM_PROMPT + LM_NEW - 1)

            _, prof_m = profiled(torch, mesh_steps)
            _, prof_0 = profiled(torch, plain_steps)
        del dcache, cache0, cache_m, grown
        # --- the train step at full width -------------------------------
        tplan = CellPlan(arch=LM_ARCH, shape="train", kind="train",
                         seq=LM_PROMPT, global_batch=LM_MESH_TRAIN_BATCH,
                         n_micro=LM_MESH_MICRO,
                         b_local=LM_MESH_TRAIN_BATCH)
        tstep, _, sps, _, tbps = S.build_lm_train_step(api, mesh, tplan)
        stream = lm_example_stream(LM_MESH_TRAIN_BATCH, LM_PROMPT,
                                   cfg.vocab, seed=5)
        batches = [{"tokens": torch.from_numpy(a).to(dev),
                    "targets": torch.from_numpy(b).to(dev)}
                   for _, a, b in (next(stream)
                                   for _ in range(LM_MESH_TRAIN_STEPS))]
        opt = S.make_optimizer_for(cfg)
        xent = _xent_attribution(torch, api, params, batches[0], mesh,
                                 LM_MESH_MICRO)
        # the mesh step in lockstep with the mesh-free model trained
        # through the same (vocab-parallel) cross-entropy; compared after
        # every step
        hstep = build_microbatched_train_step(
            _vocab_parallel_loss(api, mesh)[1], opt, LM_MESH_MICRO)
        losses_m, step_ms, losses_h, gaps = [], [], [], []
        state = S.shard_tree(init_state(tree.tree_map(
            lambda t: t.clone(), params), opt), sps, mesh)
        state_h = init_state(tree.tree_map(lambda t: t.clone(), params),
                             opt)
        dbatches = [S.shard_tree(b, tbps, mesh) for b in batches]
        arg_real["train"] = S.local_bytes((state, dbatches[0]))
        peak["train"] = 0
        for b, db in zip(batches, dbatches):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state, loss = tstep(state, db)
            losses_m.append(float(loss.full_tensor()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            peak["train"] = max(peak["train"],
                                torch.cuda.max_memory_allocated() - base
                                + arg_real["train"])
            state_h, loss_h = hstep(state_h, b)
            losses_h.append(float(loss_h))
            gaps.append(_train_state_gap(torch, state, state_h))
        del state, state_h
        torch.cuda.empty_cache()
        # and the mesh-free step as the lm phase trains (the gather
        # cross-entropy): its losses
        mstep = build_microbatched_train_step(
            lambda p, b: api.loss_fn(p, b), opt, LM_MESH_MICRO)
        state0 = init_state(tree.tree_map(lambda t: t.clone(), params), opt)
        losses_0 = []
        for b in batches:
            state0, loss0 = mstep(state0, b)
            losses_0.append(float(loss0))
        del state0
        torch.cuda.empty_cache()
        train_rel = [abs(a - b) / abs(b) for a, b in zip(losses_m,
                                                          losses_0)]
        print(f"lm_mesh: build_lm_train_step against the mesh-free step "
              f"through the same vocab-parallel cross-entropy, per step: "
              f"{json.dumps(gaps)}, losses {losses_m} vs {losses_h}; the "
              f"gather cross-entropy's dlogits on the same logits differ in "
              f"{xent['dlogits_differ']} of {xent['dlogits_n']} (max "
              f"{xent['dlogits_err']:.3g}, largest "
              f"{xent['dlogits_scale']:.3g}), the mesh-free mean gradients "
              f"through the two in {xent['grad_differ']} of "
              f"{xent['grad_n']} (largest gap {xent['grad_rel']:.3g} of its "
              f"leaf's largest) card={card}")
        bad = []
        for i, g in enumerate(gaps):
            if g["p_err"] > LM_MESH_TRAIN_ATOL or \
                    g["m_rel"] > LM_MESH_TRAIN_ATOL:
                bad.append(f"step {i + 1}: {g}")
        if max(abs(a - b) for a, b in zip(losses_m, losses_h)) > \
                LM_LOSS_RTOL * abs(losses_h[0]):
            bad.append(f"losses {losses_m} vs {losses_h}")
        if train_rel[0] > LM_LOSS_RTOL or \
                max(train_rel[1:]) > LM_MESH_STEP2_RTOL:
            bad.append(f"losses {losses_m} vs the gather cross-entropy's "
                       f"{losses_0}")
        if bad:
            fail(f"lm_mesh: build_lm_train_step vs the mesh-free steps: "
                 f"{bad}")
        # --- the paper's linear step at k=500, b=16 -----------------------
        paper = PaperConfig(k=PAPER_K, b=PAPER_B)
        lstep, _, lsps, _ = S.build_linear_train_step(paper, mesh)
        g = torch.Generator(device=dev).manual_seed(3)
        n = paper.global_batch
        codes = torch.randint(0, 1 << PAPER_B, (n, PAPER_K), generator=g,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, 2, (n,), generator=g, device=dev,
                               dtype=torch.int32)
        table = 0.01 * torch.randn((PAPER_K, 1 << PAPER_B, 1),
                                   generator=g, device=dev)
        p_lin = {"table": table, "bias": torch.zeros(1, device=dev)}
        lopt = adamw(1e-2, AdamWConfig())
        lstate = S.shard_tree(init_state(tree.tree_map(
            lambda t: t.clone(), p_lin), lopt), lsps, mesh)
        lbps = S.batch_pspecs(mesh, {"c": codes, "l": labels})
        dcodes = S.shard_tree(codes, lbps["c"], mesh)
        dlabels = S.shard_tree(labels, lbps["l"], mesh)
        lcfg = BBitLinearConfig(k=PAPER_K, b=PAPER_B)
        plain = build_train_step(mean_loss_fn(
            lambda p, c: bbit_logits(p, c, lcfg), paper.loss, l2=1e-7),
            lopt)
        lstate0 = init_state(tree.tree_map(lambda t: t.clone(), p_lin),
                             lopt)
        lin_m, lin_0, lin_ms = [], [], []
        for _ in range(LM_MESH_LINEAR_STEPS):
            t0 = time.perf_counter()
            lstate, lm_loss = lstep(lstate, dcodes, dlabels)
            lin_m.append(float(lm_loss.full_tensor()))
            lin_ms.append((time.perf_counter() - t0) * 1e3)
            lstate0, l0 = plain(lstate0, codes, labels)
            lin_0.append(float(l0))
        lin_rel = max(abs(a - b) / abs(b) for a, b in zip(lin_m, lin_0))
        if lin_rel > LM_LOSS_RTOL:
            fail(f"lm_mesh: linear losses {lin_m} vs mesh-free {lin_0}")
        del lstate, lstate0, codes, table
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    arg_equal = {k: predicted[k]["argument_bytes"] == arg_real[k]
                 for k in arg_real}
    peak_ratio = {k: predicted[k]["peak_bytes"] / peak[k] for k in peak}
    workdir = os.path.join(ROOT, "build", "chip_smoke_lm")
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        train_cli = _launcher(torch, "train", [
            "--workdir", workdir, "--steps", "20", "--batch-size", "8",
            "--seq-len", "64", "--ckpt-every", "10"], card)
        serve_cli = _launcher(torch, "serve", [
            "--max-batch", "4", "--tokens", "8"], card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = [ln for ln in train_cli["stdout"] if ": loss " in ln][-1]
    first, last = (float(v) for v in line.split()[2:5:2])
    if not last < first:
        fail(f"lm_mesh: --mode lm's loss did not fall: {line}")
    rec.update(
        prefill_ms=prefill_ms, prefill_meshfree_ms=prefill0_ms,
        prefill_err=prefill_err, prefill_tol=tol,
        decode_ms=decode_ms, decode_meshfree_ms=decode0_ms,
        decode_device_ms=prof_m["device_ms"] / LM_PROFILE_STEPS,
        decode_meshfree_device_ms=prof_0["device_ms"] / LM_PROFILE_STEPS,
        tokens_equal=parted is None, parted=parted,
        train_step_ms=step_ms, train_losses=losses_m,
        train_losses_microbatched=losses_0, train_rel=train_rel,
        train_losses_vocab_parallel=losses_h, train_gaps=gaps,
        train_xent=xent,
        linear_losses=lin_m, linear_losses_meshfree=lin_0,
        linear_rel=lin_rel, linear_step_ms=lin_ms,
        argument_bytes=arg_real, argument_bytes_equal=arg_equal,
        peak_bytes=peak, peak_ratio=peak_ratio,
        train_cli=train_cli, serve_cli=serve_cli)
    print(f"lm_mesh: one-rank {rec['backend']} DeviceMesh (data=1, model=1) "
          f"on cuda:0, {LM_ARCH} as registered: prefill {LM_BATCH} x "
          f"{LM_PROMPT} {prefill_ms:.3f} ms (mesh-free {prefill0_ms:.3f}), "
          f"logits max|diff| {prefill_err:.4g} (bound {tol:.4g}); decode "
          f"{decode_ms:.3f} ms a step (mesh-free {decode0_ms:.3f}; device "
          f"{rec['decode_device_ms']:.3f} vs "
          f"{rec['decode_meshfree_device_ms']:.3f} ms over "
          f"{LM_PROFILE_STEPS} profiled steps; the dry-run's trace of a "
          f"step: {predicted['decode']['dtensor_ops']} DTensor ops, "
          f"{predicted['decode']['local_ops']} local ops); greedy tokens "
          f"equal the "
          f"lm phase's: {parted is None}"
          + (f" (parted {json.dumps(parted)})" if parted else "")
          + f" card={card}")
    print(f"lm_mesh: build_lm_train_step {LM_MESH_TRAIN_BATCH} x "
          f"{LM_PROMPT}, n_micro {LM_MESH_MICRO}: step ms "
          f"{[round(x, 3) for x in step_ms]}, losses {losses_m} vs "
          f"build_microbatched_train_step {losses_0} (rel "
          f"{[float(f'{x:.3g}') for x in train_rel]}); linear k={PAPER_K} "
          f"b={PAPER_B} on {paper.global_batch} rows: step ms "
          f"{[round(x, 3) for x in lin_ms]}, losses {lin_m} vs mesh-free "
          f"{lin_0} (rel {lin_rel:.3g}) card={card}")
    print(f"lm_mesh: dry-run prediction vs the card: argument bytes "
          f"{json.dumps({k: [predicted[k]['argument_bytes'], arg_real[k]] for k in arg_real})} "
          f"equal {json.dumps(arg_equal)}; peak bytes predicted / "
          f"allocated {json.dumps({k: round(v, 4) for k, v in peak_ratio.items()})} "
          f"(allocated {json.dumps(peak)}); total_memory {total_memory} "
          f"(dryrun.HBM_BUDGET_BYTES {dryrun.HBM_BUDGET_BYTES}) card={card}")
    print(f"lm_mesh: launch/train.py --mode lm: {train_cli['stdout'][-1]} "
          f"({train_cli['seconds']:.1f} s); launch/serve.py --mode lm: "
          f"{serve_cli['stdout'][0]} ({serve_cli['seconds']:.1f} s)")
    if not all(arg_equal.values()):
        fail(f"lm_mesh: predicted argument bytes differ: {arg_equal}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    card = card_line()
    phase_s = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    int_rate = int32_ops_per_s(torch)

    run("build", phase_build)
    errs, edge_errs = run("kernels", phase_kernels, torch, dev)
    docs = make_corpus(DOCS, seed=0)
    engine = run("engine", phase_engine, torch, dev, docs, card)
    train, train_data = run("train", phase_train, torch, dev, card, errs)
    stream, handover = run("stream", phase_stream, torch, dev, card,
                           train_data)
    try:
        dp = run("dp", phase_dp, torch, dev, card, train_data, handover)
        serve = run("serve", phase_serve, torch, dev, card, train_data,
                    handover)
        paper, paper_data = run("paper", phase_paper, torch, dev, card,
                                train_data, errs)
        bf16 = run("bf16", phase_bf16, torch, dev, card, train_data,
                   handover, paper_data)
    finally:
        shutil.rmtree(handover["stream_work"], ignore_errors=True)
    linear = run("linear", phase_linear, torch, dev, card, train_data,
                 int_rate)
    calib = run("calibrate", phase_calibrate, torch, dev, card, train_data)
    search = run("search", phase_search, torch, dev, card,
                 train_data["rows"], errs)
    timing = run("timing", phase_timing, torch, dev, docs, card, int_rate)
    timing_train = run("timing_train", phase_timing_train, torch, dev,
                       train_data, paper_data, card, int_rate)
    timing_raw = run("timing_raw", phase_timing_raw, torch, dev,
                     train_data["rows"], search, card, int_rate)
    sliced = run("b7_slices", phase_b7_slices, torch, dev, card)
    lm = run("lm", phase_lm, torch, dev, card)
    lm_mesh = run("lm_mesh", phase_lm_mesh, torch, dev, card)
    print(f"phases (s): {json.dumps(phase_s)}")

    # each kernel's line: its launches summed over the main paths' runs
    # (engine, train, gradient, stream, dp, serve, paper, bf16, linear,
    # calibrate, search; the dp gang's workers count apart), its error
    # and time at its main path's shapes
    launches = {name: engine["launches"].get(name, 0)
                + train["counts"][name]
                + train["grad"]["launches"].get(name, 0)
                + paper["counts"][name]
                + search["counts"].get(name, 0)
                + stream["counts"][name]
                + dp["counts"][name]
                + serve["counts"][name]
                + linear["counts"][name]
                + calib["counts"][name]
                + bf16["counts"][name]
                for name in KERNELS}
    main_rec = {**timing["main"], **timing_train["main"],
                **timing_raw["main"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = main_rec[name]
        if launches[name] < 1:
            fail(f"kernel {name} was launched on no main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **rec})
        if name == "bbit_linear_fwd":
            kernels[-1]["sliced"] = sliced["float32"]
    # the bfloat16 table instantiations of B5-B8: launched on the bf16
    # phase's main path only
    for name in KERNELS_BF16:
        base = name[:-len("_bf16")]
        if bf16["counts"][name] < 1:
            fail(f"kernel {name} was launched on no main path")
        kernels.append({"name": name, "route": "cuda",
                        "source": KERNELS[base][0],
                        "replaces": KERNELS[base][1],
                        "launches": bf16["counts"][name],
                        "max_abs_err": bf16["kernels"]["errs"][name],
                        **bf16["kernels"]["main"][name]})
        if name == "bbit_linear_fwd_bf16":
            kernels[-1]["sliced"] = sliced["bfloat16"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "int32_ops_per_s": int_rate,
                       "launch_floor_ms": timing["launch_floor_ms"],
                       "kernels": kernels, "edge_max_abs_err": edge_errs,
                       "timing": timing["shapes"],
                       "timing_train": timing_train["shapes"],
                       "timing_raw": timing_raw["shapes"],
                       "b7_slices": sliced, "train": train,
                       "paper": paper, "stream": stream, "dp": dp,
                       "serve": serve, "bf16": bf16,
                       "linear": linear, "calibrate": calib, "lm": lm,
                       "lm_mesh": lm_mesh,
                       "search": {k: search[k] for k in ("counts", "recall",
                                                         "candidates")},
                       "docs_per_s": engine["docs_per_s"],
                       "profiles": engine["profiles"], "phase_s": phase_s,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
