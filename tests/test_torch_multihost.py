"""The port's multi-process gangs on the CPU over gloo (the reference's
tests/test_multihost.py): every gang here is ``procs`` real worker
processes (``python -m repro_torch.train.worker`` through
``train.supervisor.run_multiprocess_supervised``) joined by
``torch.distributed`` at a localhost coordinator.

The equivalence claims rest on the dp step's scale after the reduction
(``train.data_parallel``): a 2-rank gang of one slot each, a 1-process
fold of 2 slots, and any kill/resume splice of the two give the same
bits (a + b is commutative; ÷ 2 and × 2/total are exact).  A 2 × 2 gang
sums four slots in another order than a fold of 4, so it is held to
determinism only.  The archive is the 240-document one of
tests/test_torch_dp_streaming.py (k=16, b=4, 4 shards, batch 32), two
epochs of 8 steps with a checkpoint at every group.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import tree
from repro_torch.data import hashed_dataset as thd
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.distributed.runtime import read_heartbeats
from repro_torch.ft.faults import FaultEvent, FaultPlan
from repro_torch.ft.retry import BackoffPolicy
from repro_torch.models.linear import BBitLinearConfig
from repro_torch.train.streaming import fit_streaming
from repro_torch.train.supervisor import (RestartPolicy,
                                          run_multiprocess_supervised)

CFG = BBitLinearConfig(k=16, b=4)
# the shared hyperparameters of every run in the equivalence matrix
FIT = dict(epochs=2, batch_size=32, lr=5e-3, seed=0, data_parallel=2,
           elastic=True, prefetch=0, device="cpu")
POLICY = RestartPolicy(max_restarts=3,
                       backoff=BackoffPolicy(base_s=0.05, cap_s=0.5))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=2000, max_triples_per_doc=1000)
    rows, labels = generate_arrays(240, cfg)
    root = str(tmp_path_factory.mktemp("mh") / "arch")
    thd.preprocess_and_save(root, rows, labels, k=16, b=4, seed=1,
                            n_shards=4, scheme="oph_zero", chunk=64,
                            device="cpu")
    return root


@pytest.fixture(scope="module")
def baseline(archive):
    """The single-process ground truth: one device folding both logical
    slots, the path every 2-slot gang topology must match bit for bit."""
    res = fit_streaming(archive, CFG, **FIT)
    return {"params": [t.numpy() for t in tree.leaves(res.params)],
            "avg": [t.numpy() for t in tree.leaves(res.avg_params)],
            "n_steps": res.n_steps, "examples_seen": res.examples_seen,
            "shards_processed": res.shards_processed,
            "progressive_acc": res.progressive_acc}


def _matches(params_npz_path, baseline) -> None:
    got = np.load(params_npz_path)
    assert len(got.files) == len(baseline["params"]) + len(baseline["avg"])
    for i, leaf in enumerate(baseline["params"]):
        assert np.array_equal(got[f"p{i}"], leaf), f"params leaf {i}"
    for i, leaf in enumerate(baseline["avg"]):
        assert np.array_equal(got[f"a{i}"], leaf), f"avg leaf {i}"


def _gang(archive, run_dir, *, procs=2, local_devices=1, fault=None,
          **overrides):
    return run_multiprocess_supervised(
        archive, CFG, procs=procs, run_dir=run_dir,
        local_devices=local_devices, policy=POLICY,
        fault_spec=fault.to_spec() if fault else None,
        attempt_timeout_s=120.0, ckpt_dir=os.path.join(run_dir, "ckpt"),
        **dict(FIT, **overrides))


def _logs(run_dir, rank):
    return "".join(open(os.path.join(run_dir, f), errors="replace").read()
                   for f in sorted(os.listdir(run_dir))
                   if f.startswith(f"log_rank{rank}"))


def test_gang_matches_single_process(archive, baseline, tmp_path):
    run_dir = str(tmp_path / "gang")
    run = _gang(archive, run_dir)
    assert run.restarts == 0 and len(run.attempt_s) == 1
    for r in (0, 1):
        rec = run.results[r]
        assert rec["n_steps"] == baseline["n_steps"] == 8
        assert rec["examples_seen"] == baseline["examples_seen"]
        assert rec["shards_processed"] == baseline["shards_processed"]
        assert rec["progressive_acc"] == baseline["progressive_acc"]
        assert rec["backend"] == "gloo" and rec["device"] == "cpu"
        assert rec["lineage"] == [{"logical": 2, "physical": 2,
                                   "procs": 2, "devices": 2,
                                   "from_step": 0}]
        # exactly two all-reduces a step: the scalar triple, the gradient
        coll = rec["collectives"]
        assert coll["count"] == 2 * rec["n_steps"] and coll["all-gather"] == 0
        assert coll["all-reduce"] == rec["n_steps"] * (12 + 4 * (16 * 16 + 1))
        assert rec["kernel_counts"]["bbit_linear_packed_fwd_plain"] > 0
        _matches(run.params_paths[r], baseline)
    hb = read_heartbeats(run_dir)
    assert set(hb) == {0, 1} and {h["phase"] for h in hb.values()} == {
        "done"}


def test_gang_worker_kill9_recovers_bitwise(archive, baseline, tmp_path):
    # kill -9 the rank that does not commit, mid-epoch: no cleanup
    plan = FaultPlan([FaultEvent(site="proc_kill", step=5, rank=1,
                                 times=1)])
    run = _gang(archive, str(tmp_path / "gang"), fault=plan)
    assert run.restarts == 1 and len(run.attempt_s) == 2
    assert "signal 9" in run.crashes[0].error
    assert run.crashes[0].recover_s > 0
    assert run.result["n_steps"] == baseline["n_steps"]
    _matches(run.params_paths[0], baseline)
    _matches(run.params_paths[1], baseline)


def test_gang_leader_killed_during_manifest_commit(archive, baseline,
                                                   tmp_path):
    # rank 0 dies after every rank payload of step 4 is staged, before
    # the manifest commits: step 2 stays the newest, the replay splices
    plan = FaultPlan([FaultEvent(site="manifest_write", at_save=4, rank=0,
                                 times=1)])
    run_dir = str(tmp_path / "gang")
    run = _gang(archive, run_dir, fault=plan)
    assert run.restarts >= 1
    assert run.result["shards_processed"] == baseline["shards_processed"]
    _matches(run.params_paths[0], baseline)
    _matches(run.params_paths[1], baseline)
    assert json.load(open(os.path.join(run_dir, "fault_state_rank0.json"))
                     ) == {"0": 1}


def test_gang_torn_rank_payload_quarantined(archive, baseline, tmp_path):
    # rank 1's payload of step 2 is torn after its rename (the CRCs come
    # from memory): the commit succeeds, the respawned rank 1 detects the
    # tear, quarantines its own payload and takes rank 0's
    plan = FaultPlan([FaultEvent(site="ckpt_write", at_save=2, rank=1,
                                 times=1)])
    run_dir = str(tmp_path / "gang")
    run = _gang(archive, run_dir, fault=plan)
    assert run.restarts == 1
    _matches(run.params_paths[0], baseline)
    _matches(run.params_paths[1], baseline)
    text = _logs(run_dir, 1)
    assert "injected torn rank-1 checkpoint write" in text
    assert "quarantining" in text and "rank_00001.quarantined" in text


def test_elastic_gang_to_single_process(archive, baseline, tmp_path):
    # a 2-process gang checkpoints mid-run; one process adopts the
    # coordinated checkpoint and finishes (N -> 1), bit for bit
    run_dir = str(tmp_path / "gang")
    part = _gang(archive, run_dir, stop_after_shards=4)
    assert part.result["completed"] is False
    assert part.result["shards_processed"] == 4
    ck = os.path.join(run_dir, "ckpt")
    # a resume that is not elastic refuses the new gang size
    with pytest.raises(ValueError, match="elastic=True"):
        fit_streaming(archive, CFG, ckpt_dir=ck, **dict(FIT, elastic=False))
    res = fit_streaming(archive, CFG, ckpt_dir=ck, **FIT)
    assert res.completed and res.shards_processed == 8
    assert res.examples_seen == baseline["examples_seen"]
    assert res.n_steps == baseline["n_steps"]
    for got, want in zip(tree.leaves(res.params), baseline["params"]):
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(tree.leaves(res.avg_params), baseline["avg"]):
        assert np.array_equal(got.numpy(), want)
    assert [r["procs"] for r in res.topology_lineage] == [2, 1]


def test_elastic_single_process_to_gang(archive, baseline, tmp_path):
    # the reverse splice: one process checkpoints (the plain layout)
    # mid-run, a 2-process gang adopts it and finishes (1 -> N)
    run_dir = str(tmp_path / "gang")
    part = fit_streaming(archive, CFG, stop_after_shards=4,
                         ckpt_dir=os.path.join(run_dir, "ckpt"), **FIT)
    assert part.completed is False and part.shards_processed == 4
    run = _gang(archive, run_dir)
    rec = run.result
    assert rec["completed"] and rec["shards_processed"] == 8
    assert rec["n_steps"] == baseline["n_steps"]
    assert rec["examples_seen"] == baseline["examples_seen"]
    _matches(run.params_paths[0], baseline)
    _matches(run.params_paths[1], baseline)
    assert [r["procs"] for r in rec["lineage"]] == [1, 2]


def test_gang_two_by_two_deterministic(archive, tmp_path):
    # 2 ranks x 2 local devices: the 4-slot sum is not the fold's, so
    # the claim is ranks that agree and runs that repeat
    r1 = _gang(archive, str(tmp_path / "g1"), local_devices=2,
               data_parallel=4)
    r2 = _gang(archive, str(tmp_path / "g2"), local_devices=2,
               data_parallel=4)
    a0, a1 = np.load(r1.params_paths[0]), np.load(r1.params_paths[1])
    b0 = np.load(r2.params_paths[0])
    for key in a0.files:
        assert np.array_equal(a0[key], a1[key])   # ranks agree
        assert np.array_equal(a0[key], b0[key])   # runs agree
    assert r1.result["lineage"][-1] == {
        "logical": 4, "physical": 4, "procs": 2, "devices": 4,
        "from_step": 0}


def test_gang_compressed_exchange_over_gloo(archive, tmp_path):
    # int8 payloads and float32 scales all-gathered over gloo; ranks agree
    run = _gang(archive, str(tmp_path / "g"), grad_compress=8)
    a0, a1 = np.load(run.params_paths[0]), np.load(run.params_paths[1])
    assert all(np.array_equal(a0[k], a1[k]) for k in a0.files)
    coll = run.result["collectives"]
    n = run.result["n_steps"]
    # a step: the triple's all-reduce, two all-gathers a leaf
    assert coll["count"] == 5 * n
    assert coll["all-gather"] == n * 2 * (256 + 4 + 256 + 4)
    assert run.result["progressive_acc"] > 0.5


def test_gang_config_error_exits_64_and_is_not_retried(archive, tmp_path):
    run_dir = str(tmp_path / "g")
    with pytest.raises(ValueError, match="configuration error"):
        _gang(archive, run_dir, grad_compress=4)
    assert not any(f.endswith("_try1.txt") for f in os.listdir(run_dir))
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_multiprocess_supervised(archive, CFG, procs=2,
                                    run_dir=run_dir, **FIT)


def test_train_cli_runs_a_gang_on_the_cpu(repo_src, tmp_path):
    env = dict(os.environ, PYTHONPATH=repo_src)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode",
         "stream", "--device", "cpu", "--workdir", str(tmp_path / "w"),
         "--n-docs", "200", "--k", "16", "--batch-size", "25",
         "--procs", "2"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gang of 2 procs streamed 200 rows" in proc.stdout
    assert "over gloo" in proc.stdout and "gang_restarts=0" in proc.stdout
    assert "'procs': 2" in proc.stdout
