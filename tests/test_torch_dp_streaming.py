"""Port vs reference: ``fit_streaming``'s data-parallel arm in one
process (ROADMAP A5), against the reference's own dp arm.

Both packages fit the same 240-document archive (tests/test_dp_streaming.py's
corpus, k=16, b=4, 4 shards, batch 32, 2 epochs) with ``elastic=True`` on
one device, so the logical slots fold onto it; the reference runs behind a
test-side shim of ``shard_map`` (jax 0.9 took ``check_rep`` away) and
from its own ``jax.random.key`` start, which the port takes over through
``linear_trainer._initial_params``.  For ``data_parallel`` in {1, 2, 4},
``grad_compress`` 8 and 1 at 2, minwise and ``oph_zero``: the same steps,
rows, shards, progressive accuracy and topology lineage (its ``devices``
too: one CPU in both), params and average allclose at
tests/test_torch_streaming.py's AdamW tolerance (rtol 1e-4, atol 1e-5).

Within the port: a dp resume is bitwise and rounds up to whole groups,
the refusals name the reference's reasons, ``grad_compress=None`` is the
exact path, compressed runs repeat their bits, and narrow AdamW moments
train through the serial arm and are fingerprinted.
"""
import numpy as np
import pytest
import torch

import jax

import repro.train.data_parallel as j_data_parallel
from repro.data import hashed_dataset as jhd
from repro.models.linear import (BBitLinearConfig as JCfg,
                                 init_bbit_linear as j_init)
from repro.train import fit_streaming as j_fit_streaming

from repro_torch.data import hashed_dataset as thd
from repro_torch.data.synth_rcv1 import SynthRcv1Config, generate_arrays
from repro_torch.distributed.runtime import ProcessRuntime
from repro_torch.ft import faults
from repro_torch.ft.faults import FaultEvent, FaultPlan
from repro_torch.ft.retry import BackoffPolicy
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.models.linear import BBitLinearConfig, params_from_jax
from repro_torch.train import linear_trainer
from repro_torch.train.metrics import trees_bitwise_equal
from repro_torch.train.streaming import fit_streaming
from repro_torch.train.supervisor import RestartPolicy, run_supervised

K, B = 16, 4
LCFG = BBitLinearConfig(k=K, b=B)
KW = dict(epochs=2, batch_size=32, lr=5e-3, seed=0)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def reference_dp(monkeypatch):
    """The reference's dp arm on jax 0.9 (``shard_map`` without
    ``check_rep``), and the port's start drawn as the reference's."""
    _sm = jax.shard_map

    def shim(f, **kw):
        kw.pop("check_rep", None)
        return _sm(f, check_vma=False, **kw)
    monkeypatch.setattr(j_data_parallel, "shard_map", shim)

    def start(cfg, seed, device):
        jcfg = JCfg(k=cfg.k, b=cfg.b, n_classes=cfg.n_classes,
                    normalize=cfg.normalize)
        return params_from_jax(
            {n: np.asarray(v)
             for n, v in j_init(jcfg, jax.random.key(seed)).items()},
            device=device)
    monkeypatch.setattr(linear_trainer, "_initial_params", start)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """scheme → (the reference's archive, the port's), byte-equal."""
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=2000, max_triples_per_doc=1000)
    rows, labels = generate_arrays(240, cfg)
    d = tmp_path_factory.mktemp("dp")
    out = {}
    for scheme in ("minwise", "oph_zero"):
        ref, port = str(d / f"ref_{scheme}"), str(d / f"port_{scheme}")
        kw = dict(k=K, b=B, seed=1, n_shards=4, scheme=scheme, chunk=64)
        jhd.preprocess_and_save(ref, rows, labels, **kw)
        thd.preprocess_and_save(port, rows, labels, device="cpu", **kw)
        out[scheme] = (ref, port)
    return out


def _close(port, ref):
    for name in ("bias", "table"):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]),
                                   **TOL, err_msg=name)


def _lineage(res):
    return [{k: v for k, v in r.items() if k != "devices"}
            for r in res.topology_lineage]


@pytest.mark.parametrize("scheme", ["minwise", "oph_zero"])
@pytest.mark.parametrize("dp,compress", [(1, None), (2, None), (4, None),
                                         (2, 8), (2, 1)])
def test_fit_streaming_dp_matches_reference(archives, scheme, dp, compress,
                                            reference_dp):
    ref, port = archives[scheme]
    kw = dict(KW, data_parallel=dp, elastic=True, grad_compress=compress)
    want = j_fit_streaming(ref, JCfg(k=K, b=B), **kw)
    got = fit_streaming(port, LCFG, device="cpu", **kw)
    assert (got.n_steps, got.examples_seen, got.shards_processed) == (
        want.n_steps, want.examples_seen, want.shards_processed)
    assert got.progressive_acc == want.progressive_acc
    assert got.completed and want.completed
    assert _lineage(got) == _lineage(want) == [
        {"logical": dp, "physical": 1, "procs": 1, "from_step": 0}]
    assert got.topology_lineage[0]["devices"] == 1
    _close(got.params, want.params)
    _close(got.avg_params, want.avg_params)


def test_dp_uneven_groups_match_reference(tmp_path, reference_dp):
    """tests/test_dp_streaming.py's 250 documents in 5 oph_zero shards at
    data_parallel=2: the last group has one shard, so slot 1 trains on
    padding rows alone (zero rows, zero gradient) in every step of it."""
    cfg = SynthRcv1Config(seed=11, topic_tokens=150, background_frac=0.35,
                          max_pairs_per_doc=2000, max_triples_per_doc=1000)
    rows, labels = generate_arrays(250, cfg)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(k=K, b=B, seed=1, n_shards=5, scheme="oph_zero", chunk=64)
    jhd.preprocess_and_save(ref, rows, labels, **kw)
    thd.preprocess_and_save(port, rows, labels, device="cpu", **kw)
    fit = dict(KW, data_parallel=2, elastic=True)
    want = j_fit_streaming(ref, JCfg(k=K, b=B), **fit)
    got = fit_streaming(port, LCFG, device="cpu", **fit)
    assert (got.n_steps, got.examples_seen, got.shards_processed) == (
        want.n_steps, want.examples_seen, 10)
    assert got.examples_seen == 2 * 250
    assert got.progressive_acc == want.progressive_acc
    _close(got.params, want.params)
    _close(got.avg_params, want.avg_params)


def test_dp_world_one_schedules_like_the_serial_arm(archives):
    port = archives["minwise"][1]
    one = fit_streaming(port, LCFG, data_parallel=1, elastic=True,
                        device="cpu", **KW)
    ser = fit_streaming(port, LCFG, device="cpu", **KW)
    assert (one.n_steps, one.examples_seen) == (ser.n_steps,
                                                ser.examples_seen)
    assert abs(one.progressive_acc - ser.progressive_acc) < 0.02
    assert _lineage(ser) == [{"logical": 1, "physical": 1, "procs": 1,
                              "from_step": 0}]


def test_dp_resume_is_bitwise_and_refuses_other_schedules(archives,
                                                          tmp_path):
    port = archives["oph_zero"][1]
    kw = dict(KW, data_parallel=2, elastic=True, prefetch=0)
    straight = fit_streaming(port, LCFG, device="cpu", **kw)
    again = fit_streaming(port, LCFG, device="cpu", **dict(kw, prefetch=2))
    assert trees_bitwise_equal(straight.params, again.params)
    ck = str(tmp_path / "ck")
    part = fit_streaming(port, LCFG, ckpt_dir=ck, stop_after_shards=3,
                         device="cpu", **kw)
    # group granularity: 3 requested rounds up to 2 groups
    assert not part.completed and part.shards_processed == 4
    res = fit_streaming(port, LCFG, ckpt_dir=ck, device="cpu", **kw)
    assert res.completed and res.shards_processed == 8
    assert trees_bitwise_equal(straight.params, res.params)
    assert trees_bitwise_equal(straight.avg_params, res.avg_params)
    assert (res.n_steps, res.examples_seen, res.progressive_acc) == (
        straight.n_steps, straight.examples_seen, straight.progressive_acc)
    with pytest.raises(ValueError, match="pass elastic=True to adopt"):
        fit_streaming(port, LCFG, ckpt_dir=ck, device="cpu", **KW)
    # elastic adopts the checkpoint's logical schedule instead
    adopted = fit_streaming(port, LCFG, ckpt_dir=ck, elastic=True,
                            device="cpu", **KW)
    assert adopted.n_steps == res.n_steps


def test_dp_refusals_name_the_reason(archives):
    port = archives["minwise"][1]
    with pytest.raises(ValueError, match="pass elastic=True"):
        fit_streaming(port, LCFG, data_parallel=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="data_parallel"):
        fit_streaming(port, LCFG, grad_compress=8, device="cpu", **KW)
    with pytest.raises(ValueError, match="grad_compress must be"):
        fit_streaming(port, LCFG, data_parallel=2, elastic=True,
                      grad_compress=4, device="cpu", **KW)
    rt = ProcessRuntime(procs=2, rank=0)
    with pytest.raises(ValueError, match="requires data_parallel"):
        fit_streaming(port, LCFG, runtime=rt, device="cpu", **KW)
    with pytest.raises(ValueError, match="process group"):
        fit_streaming(port, LCFG, runtime=rt, data_parallel=2,
                      elastic=True, device="cpu", **KW)
    with pytest.raises(ValueError, match="evenly"):
        fit_streaming(port, LCFG, runtime=ProcessRuntime(procs=2),
                      data_parallel=3, elastic=True, device="cpu", **KW)


def test_grad_compress_off_is_exact_and_on_repeats(archives):
    port = archives["minwise"][1]
    kw = dict(KW, data_parallel=2, elastic=True)
    exact = fit_streaming(port, LCFG, device="cpu", **kw)
    off = fit_streaming(port, LCFG, grad_compress=None, device="cpu", **kw)
    assert trees_bitwise_equal(exact.params, off.params)
    for bits in (8, 1):
        comp = fit_streaming(port, LCFG, grad_compress=bits, device="cpu",
                             **kw)
        assert not trees_bitwise_equal(comp.params, exact.params)
        again = fit_streaming(port, LCFG, grad_compress=bits,
                              device="cpu", **kw)
        assert trees_bitwise_equal(comp.params, again.params)
        assert comp.progressive_acc >= exact.progressive_acc - 0.05


@pytest.mark.parametrize("md", ["bfloat16", "int8"])
def test_narrow_moments_train_and_are_fingerprinted(archives, md, tmp_path):
    port = archives["minwise"][1]
    full = fit_streaming(port, LCFG, device="cpu", **KW)
    narrow = fit_streaming(port, LCFG, moment_dtype=md, device="cpu", **KW)
    assert narrow.n_steps == full.n_steps
    for name in ("bias", "table"):
        np.testing.assert_allclose(narrow.params[name].numpy(),
                                   full.params[name].numpy(), atol=5e-3)
    ck = str(tmp_path / "ck")
    part = fit_streaming(port, LCFG, moment_dtype=md, ckpt_dir=ck,
                         stop_after_shards=2, device="cpu", **KW)
    res = fit_streaming(port, LCFG, moment_dtype=md, ckpt_dir=ck,
                        device="cpu", **KW)
    assert not part.completed and trees_bitwise_equal(res.params,
                                                      narrow.params)
    with pytest.raises(ValueError, match="incompatible"):
        fit_streaming(port, LCFG, ckpt_dir=ck, device="cpu", **KW)


def test_straggler_escalation_counted(archives, tmp_path):
    """Two injected 0.3 s steps (of 16) against a millisecond median
    escalate, and the count surfaces on the supervised run (the
    reference's tests/test_multihost.py case, in one process)."""
    port = archives["minwise"][1]
    plan = FaultPlan([FaultEvent(site="slow_step", step=s, delay_s=0.3,
                                 times=1) for s in (10, 11)])
    wd = StepWatchdog(threshold=3.0, window=16, escalate_after=2)
    with faults.arm(plan):
        sup = run_supervised(
            port, LCFG, watchdog=wd, ckpt_dir=str(tmp_path / "ck"),
            policy=RestartPolicy(max_restarts=1,
                                 backoff=BackoffPolicy(base_s=0.01)),
            data_parallel=2, elastic=True, prefetch=0, device="cpu",
            **dict(KW, epochs=4))
    assert sup.result.completed and sup.restarts == 0
    assert sup.straggler_escalations >= 1
    assert torch.is_tensor(sup.result.params["table"])
