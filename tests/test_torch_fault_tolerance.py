"""The port's crash-safe streaming training (the serial cases of
tests/test_fault_tolerance.py and tests/test_checkpoint.py): retry
backoff equal to the reference's, transient and persistent shard-read
faults, CRC fsck of shards, torn and corrupt checkpoints quarantined with
fallback, supervised crashes that end bit-identical to an uninterrupted
run, the restart budget, the params handoff to serving read across the
two packages, and the training CLI.  Everything runs on the CPU."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as jckpt
from repro.ft.retry import BackoffPolicy as JBackoffPolicy
from repro.models.linear import (BBitLinearConfig as JCfg,
                                 init_bbit_linear as j_init)

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data import hashed_dataset
from repro_torch.data.hashed_dataset import (ShardCorruptionError,
                                             ShardReadError, verify_shard)
from repro_torch.data.prefetch import ShardStreamError, ThreadedPrefetcher
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.ft import faults
from repro_torch.ft.faults import FaultEvent, FaultPlan, InjectedCrash
from repro_torch.ft.retry import BackoffPolicy
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.models.linear import BBitLinearConfig, params_from_jax
from repro_torch.train.metrics import trees_bitwise_equal
from repro_torch.train.streaming import fit_streaming
from repro_torch.train.supervisor import RestartPolicy, run_supervised

_KW = dict(epochs=2, batch_size=32, lr=5e-3, seed=0, device="cpu")
_LCFG = BBitLinearConfig(k=16, b=4)


def _build_archive(root, n_docs=160, n_shards=2):
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=2000, max_triples_per_doc=1000)
    rows, labels = generate_arrays(n_docs, cfg)
    hashed_dataset.preprocess_and_save(root, rows, labels, k=16, b=4,
                                       seed=1, n_shards=n_shards, chunk=64,
                                       device="cpu")
    return root


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    """160 docs / 2 shards: 3 steps a shard, 12 over 2 epochs, so "mid-
    shard" and "shard boundary" are distinct steps."""
    return _build_archive(str(tmp_path_factory.mktemp("ft") / "arch"))


@pytest.fixture(scope="module")
def ref_fit(arch):
    return fit_streaming(arch, _LCFG, **_KW)


def _counters_equal(a, b):
    assert a.n_steps == b.n_steps
    assert a.examples_seen == b.examples_seen
    assert a.shards_processed == b.shards_processed
    assert a.progressive_acc == b.progressive_acc


def _same_fit(ref, got):
    assert trees_bitwise_equal(ref.params, got.params)
    assert trees_bitwise_equal(ref.avg_params, got.avg_params)
    _counters_equal(ref, got)


def _fast_policy(max_restarts=3):
    return RestartPolicy(max_restarts=max_restarts,
                         backoff=BackoffPolicy(base_s=0.005, factor=2.0,
                                               cap_s=0.02, jitter_frac=0.0))


# ---------------------------------------------------------- retry ----
@pytest.mark.parametrize("kw", [
    {}, dict(base_s=0.01, factor=2.0, cap_s=0.25, jitter_frac=0.0),
    dict(base_s=1.0, factor=2.0, cap_s=60.0, jitter_frac=0.1, seed=7),
    dict(base_s=0.05, factor=3.0, cap_s=5.0, jitter_frac=0.5, seed=123)])
def test_backoff_delays_equal_the_reference(kw):
    mine, ref = BackoffPolicy(**kw), JBackoffPolicy(**kw)
    assert [mine.delay_s(a) for a in range(12)] == [
        ref.delay_s(a) for a in range(12)]


def test_read_backoff_and_restart_policy_equal_the_reference():
    from repro.data import hashed_dataset as jhd
    from repro.train.supervisor import RestartPolicy as JRestartPolicy
    assert hashed_dataset.READ_RETRIES == jhd.READ_RETRIES
    for a in range(hashed_dataset.READ_RETRIES + 1):
        assert (hashed_dataset.READ_BACKOFF.delay_s(a)
                == jhd.READ_BACKOFF.delay_s(a))
    mine, ref = RestartPolicy(), JRestartPolicy()
    assert mine.max_restarts == ref.max_restarts
    assert [mine.backoff.delay_s(a) for a in range(5)] == [
        ref.backoff.delay_s(a) for a in range(5)]


# ------------------------------------------------- fault harness ----
def test_unarmed_and_unmatched_plans_are_inert(arch, ref_fit):
    assert faults.active() is None
    plan = FaultPlan([FaultEvent(site="train_step", step=10**9),
                      FaultEvent(site="shard_read", shard=999),
                      FaultEvent(site="ckpt_write", at_save=10**9)])
    with faults.arm(plan):
        armed = fit_streaming(arch, _LCFG, **_KW)
    assert faults.active() is None
    assert all(e.fired == 0 for e in plan.events)
    _same_fit(ref_fit, armed)


def test_fault_events_fire_as_often_as_planned():
    ev = FaultEvent(site="train_step", step=4, times=2)
    plan = FaultPlan([ev, FaultEvent(site="shard_read", times=None)])
    faults.arm_plan(plan)
    try:
        faults.on_train_step(3)
        for _ in range(2):
            with pytest.raises(InjectedCrash, match="step 4"):
                faults.on_train_step(4)
        faults.on_train_step(4)
        assert ev.fired == 2
        for _ in range(5):
            with pytest.raises(IOError, match="shard 3"):
                faults.on_shard_read("/x", 3)
        assert faults.on_ckpt_write(1) is None
    finally:
        faults.disarm()
    assert faults.active() is None
    faults.on_train_step(4)                     # unarmed: nothing fires
    assert faults.on_ckpt_write(1) is None


# ------------------------------- supervised crash equivalence ----
def test_supervised_crashes_are_bit_equivalent(arch, ref_fit, tmp_path):
    """Two injected crashes, one on the first step after a shard-boundary
    checkpoint (step 3), one mid-shard (step 8): the supervised run still
    ends bit-identical to an uninterrupted one."""
    ck = str(tmp_path / "ck")
    plan = FaultPlan([FaultEvent(site="train_step", step=3, times=1),
                      FaultEvent(site="train_step", step=8, times=1)])
    with faults.arm(plan):
        sup = run_supervised(arch, _LCFG, policy=_fast_policy(),
                             ckpt_dir=ck, **_KW)
    assert [e.fired for e in plan.events] == [1, 1]
    assert sup.restarts == 2 and len(sup.crashes) == 2
    assert all(c.error.startswith("InjectedCrash") for c in sup.crashes)
    assert all(c.recover_s > 0 for c in sup.crashes)
    assert sup.result.completed
    _same_fit(ref_fit, sup.result)
    assert ckpt.latest_published(ck) == ref_fit.shards_processed


def test_supervised_torn_checkpoint_write_recovers(arch, ref_fit, tmp_path):
    """The first checkpoint write is torn (payload truncated after the
    atomic rename) and the process dies; the restart quarantines it,
    starts afresh and still ends bit-identical."""
    ck = str(tmp_path / "ck")
    plan = FaultPlan([FaultEvent(site="ckpt_write", times=1)])
    with faults.arm(plan):
        sup = run_supervised(arch, _LCFG, policy=_fast_policy(),
                             ckpt_dir=ck, **_KW)
    assert plan.events[0].fired == 1 and sup.restarts == 1
    _same_fit(ref_fit, sup.result)
    q = os.path.join(ck, ckpt.QUARANTINE_SUBDIR)
    assert os.path.isdir(q) and len(os.listdir(q)) == 1
    assert ckpt.latest_step(ck) == ref_fit.shards_processed


def test_supervised_gives_up_after_max_restarts(arch, tmp_path):
    """A persistent crash exhausts the restart budget and re-raises."""
    plan = FaultPlan([FaultEvent(site="train_step", step=0, times=None)])
    with faults.arm(plan):
        with pytest.raises(InjectedCrash):
            run_supervised(arch, _LCFG, policy=_fast_policy(max_restarts=2),
                           ckpt_dir=str(tmp_path / "ck"), **_KW)
    assert plan.events[0].fired == 3      # the first attempt + 2 restarts


def test_supervised_refuses_unrecoverable_setups(arch, tmp_path):
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_supervised(arch, _LCFG, **_KW)
    with pytest.raises(ValueError, match="resume"):
        run_supervised(arch, _LCFG, ckpt_dir=str(tmp_path / "ck"),
                       resume=False, **_KW)
    # config errors are deterministic: never retried
    plan = FaultPlan([FaultEvent(site="train_step", step=0, times=None)])
    t0 = time.perf_counter()
    with faults.arm(plan):
        with pytest.raises(ValueError, match="does not match archive"):
            run_supervised(arch, BBitLinearConfig(k=8, b=4),
                           ckpt_dir=str(tmp_path / "ck"), **_KW)
    assert time.perf_counter() - t0 < 5.0 and plan.events[0].fired == 0


def test_watchdog_flags_injected_slow_step(arch):
    wd = StepWatchdog(threshold=3.0, window=32, escalate_after=1)
    plan = FaultPlan([FaultEvent(site="slow_step", step=10, delay_s=0.3)])
    with faults.arm(plan):
        res = fit_streaming(arch, _LCFG, watchdog=wd, **_KW)
    assert res.completed and plan.events[0].fired == 1
    assert 10 in wd.flagged_steps and 10 in wd.escalations
    assert len(wd.window) == min(res.n_steps, 32)


# ------------------------------------- torn-checkpoint fallback ----
def test_restore_quarantines_corrupt_and_falls_back(tmp_path):
    ck = str(tmp_path / "ck")
    t1 = {"a": torch.arange(6, dtype=torch.float32),
          "b": np.ones(3, np.int64)}
    t2 = {"a": torch.full((6,), 7.0), "b": np.zeros(3, np.int64)}
    ckpt.save(ck, 1, t1)
    ckpt.save(ck, 2, t2)
    # silent bit rot: the same shapes, zeroed; only the CRCs catch it
    p = os.path.join(ck, "step_00000002", "ckpt.npz")
    with np.load(p) as z:
        zeroed = {k: np.zeros_like(z[k]) for k in z.files}
    np.savez(p, **zeroed)
    with pytest.raises(ckpt.CorruptCheckpointError, match="CRC mismatch"):
        ckpt.restore(ck, t1, step=2)
    got, step = ckpt.restore(ck, t1)
    assert step == 1
    assert isinstance(got["a"], torch.Tensor) and torch.equal(got["a"],
                                                              t1["a"])
    assert np.array_equal(got["b"], t1["b"])
    q = os.path.join(ck, ckpt.QUARANTINE_SUBDIR)
    assert os.listdir(q) == ["step_00000002"]
    assert ckpt.latest_step(ck) == 1
    # truncation (the torn write) trips the parser, not just the CRC
    p1 = os.path.join(ck, "step_00000001", "ckpt.npz")
    with open(p1, "r+b") as f:
        f.truncate(max(1, os.path.getsize(p1) * 3 // 5))
    with pytest.raises(FileNotFoundError, match="no valid checkpoints"):
        ckpt.restore(ck, t1)
    assert len(os.listdir(q)) == 2
    assert ckpt.restore_if_exists(ck, t1) is None


def test_checkpoint_ring_meta_and_structure(tmp_path):
    ck = str(tmp_path / "ck")
    tree = {"w": torch.arange(4, dtype=torch.float32),
            "step": torch.tensor(3, dtype=torch.int32)}
    for s in (5, 6, 7, 8):
        ckpt.save(ck, s, tree, keep_last=2,
                  extra_meta={"lineage": [{"logical": 1}]})
    assert sorted(os.listdir(ck)) == ["manifest.json", "step_00000007",
                                      "step_00000008"]
    meta = ckpt.load_meta(ck, 8)
    assert meta["ckpt_format"] == ckpt.CKPT_FORMAT == 4
    assert meta["lineage"] == [{"logical": 1}] and meta["n_leaves"] == 2
    assert set(meta["crc32"]) == {"leaf_00000", "leaf_00001"}
    assert ckpt.load_meta(ck, 5) is None
    got, step = ckpt.restore(ck, tree)
    assert step == 8 and got["step"].dtype == torch.int32
    assert trees_bitwise_equal(got, tree)
    with pytest.raises(ValueError, match="incompatible structure"):
        ckpt.restore(ck, {"w": tree["w"]})
    assert ckpt.restore_if_exists(str(tmp_path / "none"), tree) is None
    assert ckpt.run_fingerprint({"a": 1, "b": [2]}) == ckpt.run_fingerprint(
        {"b": [2], "a": 1}) == jckpt.run_fingerprint({"a": 1, "b": [2]})


def test_published_params_read_across_packages(tmp_path):
    """The reference's ``restore_published`` reads the port's published
    {"bias", "table"} snapshot, and the port reads the reference's."""
    cfg = JCfg(k=16, b=4)
    j_params = j_init(cfg, jax.random.key(3))
    t_params = params_from_jax({n: np.asarray(v) for n, v in
                                j_params.items()}, device="cpu")
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.publish_params(mine, 4, t_params)
    jckpt.publish_params(theirs, 6, j_params)
    got, step = jckpt.restore_published(
        mine, {n: jnp.zeros_like(v) for n, v in j_params.items()})
    assert step == 4 == jckpt.latest_published(mine)
    assert all(np.array_equal(np.asarray(got[n]), np.asarray(j_params[n]))
               for n in j_params)
    got, step = ckpt.restore_published(
        theirs, {n: torch.zeros_like(v) for n, v in t_params.items()})
    assert step == 6 == ckpt.latest_published(theirs)
    assert trees_bitwise_equal(got, t_params)


def test_fit_streaming_publishes_its_eval_params(arch, ref_fit, tmp_path):
    ck = str(tmp_path / "ck")
    res = fit_streaming(arch, _LCFG, ckpt_dir=ck, **_KW)
    _same_fit(ref_fit, res)
    got, step = ckpt.restore_published(
        ck, {n: torch.zeros_like(v) for n, v in res.params.items()})
    assert step == res.shards_processed
    assert trees_bitwise_equal(got, res.eval_params)
    assert ckpt.load_meta(ck, step)["schedule"] == {
        "dp": False, "logical_world": 1, "procs": 1}


# ----------------------------------------- shard read durability ----
def test_transient_shard_read_fault_is_absorbed(arch, ref_fit):
    """Two injected IOErrors on the first shard open: the reader's retries
    (3 attempts) absorb them; the run is bit-identical and nothing is
    quarantined."""
    plan = FaultPlan([FaultEvent(site="shard_read", times=2)])
    with faults.arm(plan):
        got = fit_streaming(arch, _LCFG, **_KW)
    assert plan.events[0].fired == 2
    _same_fit(ref_fit, got)
    assert arch not in hashed_dataset.quarantined_shards


@pytest.mark.parametrize("prefetch", [0, 2])
def test_persistent_shard_fault_quarantines_with_context(arch, prefetch):
    """A persistent read failure exhausts the retries; inline or through
    the prefetch thread the trainer sees a ShardStreamError naming
    (shard, epoch, position), the reader's ShardReadError its cause."""
    plan = FaultPlan([FaultEvent(site="shard_read", shard=1, times=None)])
    try:
        with faults.arm(plan):
            with pytest.raises(ShardStreamError) as exc:
                fit_streaming(arch, _LCFG, **dict(_KW, prefetch=prefetch))
        e = exc.value
        assert e.shard == 1 and e.epoch == 0 and 0 <= e.position < 2
        assert isinstance(e.__cause__, ShardReadError)
        assert e.__cause__.attempts == hashed_dataset.READ_RETRIES + 1
        assert e.__cause__.shard == 1 and e.__cause__.root == arch
        assert e.__cause__.__traceback__ is not None
        assert 1 in hashed_dataset.quarantined_shards.get(arch, [])
    finally:
        hashed_dataset.quarantined_shards.pop(arch, None)


def test_missing_shard_file_is_not_retried(tmp_path):
    root = _build_archive(str(tmp_path / "arch"), n_docs=40, n_shards=2)
    os.remove(os.path.join(root, "hashed_00001.labels.npy"))
    with pytest.raises(FileNotFoundError):
        hashed_dataset.load_packed_shard(root, 1)
    assert root not in hashed_dataset.quarantined_shards


def test_verify_shard_fsck_catches_bit_flip(tmp_path):
    root = _build_archive(str(tmp_path / "arch"), n_docs=80, n_shards=2)
    meta = hashed_dataset._read_meta(root)
    assert meta["format_version"] == 4
    assert len(meta["shard_checksums"]) == 2
    assert set(verify_shard(root, 0)) >= {"codes", "labels", "rows"}
    p = os.path.join(root, "hashed_00001.codes.npy")
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) - 1)
        last = f.read(1)
        f.seek(os.path.getsize(p) - 1)
        f.write(bytes([last[0] ^ 0xFF]))
    try:
        with pytest.raises(ShardCorruptionError, match="codes"):
            verify_shard(root, 1)
        assert hashed_dataset.quarantined_shards[root] == [1]
    finally:
        hashed_dataset.quarantined_shards.pop(root, None)
    assert set(verify_shard(root, 0)) >= {"codes"}
    assert verify_shard(root, 5) is None       # no checksum recorded


def test_shard_writer_refuses_inconsistent_appends(tmp_path):
    w = hashed_dataset.HashedShardWriter(str(tmp_path / "w"), 8, 4,
                                         n_total=6, n_shards=2)
    with pytest.raises(ValueError, match="row mismatch"):
        w.append(np.arange(2), np.zeros((3, 4), np.uint8), np.zeros(2))
    w.append(np.arange(2), np.zeros((2, 4), np.uint8), np.zeros(2))
    with pytest.raises(ValueError, match="inconsistent empty mask"):
        w.append(np.arange(2, 4), np.zeros((2, 4), np.uint8), np.zeros(2),
                 empty=np.zeros((2, 1), np.uint8))
    w.append(np.arange(2, 6), np.ones((4, 4), np.uint8), np.ones(4))
    meta = w.close()
    assert meta["shards"] == 2 and meta["n"] == 6
    with pytest.raises(RuntimeError, match="already closed"):
        w.close()
    assert hashed_dataset.shard_row_counts(str(tmp_path / "w")) == [3, 3]


# ------------------------------------------- prefetcher liveness ----
def test_prefetcher_raises_when_producer_dies_without_sentinel():
    import queue as _q
    pf = ThreadedPrefetcher.__new__(ThreadedPrefetcher)
    pf._q = _q.Queue(maxsize=1)
    pf._stop = threading.Event()
    pf._done = False
    pf._thread = threading.Thread(target=lambda: None)
    pf._thread.start()
    pf._thread.join()
    with pytest.raises(RuntimeError, match="died without delivering"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)


# ---------------------------------------------------------- the CLI ----
def _cli(repo_src, *args):
    env = dict(os.environ, PYTHONPATH=repo_src)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, env=env)


def test_train_cli_streams_on_the_cpu(repo_src, tmp_path):
    work = str(tmp_path / "w")
    proc = _cli(repo_src, "--mode", "stream", "--device", "cpu",
                "--workdir", work, "--n-docs", "200", "--k", "16",
                "--batch-size", "25", "--fail-at", "3")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "preprocessed 200 docs into 4 shards" in proc.stdout
    assert "steps=8 restarts=1" in proc.stdout
    # the archive is kept: a second run hashes nothing
    again = _cli(repo_src, "--device", "cpu", "--workdir", work,
                 "--n-docs", "200", "--k", "16", "--batch-size", "25")
    assert again.returncode == 0, again.stdout + again.stderr
    assert "preprocessed" not in again.stdout


@pytest.mark.parametrize("args,item", [(("--mode", "lm"), "A6b")])
def test_train_cli_names_what_is_not_ported(repo_src, tmp_path, args, item):
    """``--mode lm`` (ROADMAP ``item``) trains a reduced LM on the CPU,
    its loss falling."""
    proc = _cli(repo_src, "--device", "cpu", "--workdir",
                str(tmp_path / "w"), *args, "--steps", "10",
                "--batch-size", "4", "--seq-len", "16")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("internlm2-1.8b: loss")][-1]
    first, last = (float(v) for v in line.split()[2:5:2])
    assert last < first
