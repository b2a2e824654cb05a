"""``launch/train.py --mode linear`` against the reference's
``run_linear``: the same synthetic corpus hashed into byte-equal 4-shard
archives (B1's plain version here, at b=6 whose codes straddle bytes),
AdamW steps over ``bbit_logits`` (B7 forward, B8 dW, plain here) on
``HashedCodesLoader`` batches from the reference's ``jax.random.key``
start (``params_from_jax``), per-step losses and final params allclose
(rtol 1e-4, atol 1e-5), the same test accuracy; a ``--fail-at`` crash
and rerun that resumes from the checkpoint on the uninterrupted run's
bits; the CLI in a subprocess."""
import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from repro.launch import train as jtrain
from repro.models.linear import BBitLinearConfig as JCfg
from repro.models.linear import init_bbit_linear as j_init

from repro_torch import perf
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models.linear import BBitLinearConfig, params_from_jax
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.metrics import trees_bitwise_equal
from repro_torch.train.steps import init_state

RUN = dict(n_docs=200, k=32, b=6, steps=20, batch_size=32, lr=1e-2,
           seed=0, ckpt_every=5)
TOL = dict(rtol=1e-4, atol=1e-5)


def _args(workdir, **over):
    kw = dict(RUN, workdir=str(workdir), fail_at=None, device="cpu")
    kw.update(over)
    return argparse.Namespace(**kw)


def _reference_start(lcfg, seed, device):
    """The reference's start, ``init_bbit_linear(cfg, jax.random.key)``."""
    p = j_init(JCfg(k=lcfg.k, b=lcfg.b), jax.random.key(seed))
    return params_from_jax({n: np.asarray(v) for n, v in p.items()},
                           device=device)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run_linear (its per-step losses recorded by
    wrapping its train step) and the port's, from the same start."""
    base = tmp_path_factory.mktemp("linear")
    mp = pytest.MonkeyPatch()
    ref_losses = []
    import repro.train.steps as jsteps
    build = jsteps.build_train_step

    def recording_build(loss_fn, opt):
        step = build(loss_fn, opt)

        def run(state, *batch):
            state, loss = step(state, *batch)
            ref_losses.append(float(loss))
            return state, loss
        return run

    mp.setattr(jsteps, "build_train_step", recording_build)
    try:
        ref = jtrain.run_linear(_args(base / "jax"))
    finally:
        mp.undo()
    mp.setattr(ttrain, "_initial_params", _reference_start)
    try:
        perf.reset()
        ops.reset_counts()
        mine = ttrain.run_linear(_args(base / "torch"))
        counts = ops.counts()
        report = perf.dispatch_report()
    finally:
        mp.undo()
        perf.reset()
    return dict(base=base, ref=ref, ref_losses=ref_losses, mine=mine,
                counts=counts, report=report)


def test_archive_bytes_equal_the_reference(runs):
    jdir, tdir = runs["base"] / "jax" / "hashed", runs["base"] / "torch" / \
        "hashed"
    names = sorted(n for n in os.listdir(jdir) if n.endswith(".npy"))
    assert len(names) == 4 * 3
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def test_losses_params_and_accuracy_match_the_reference(runs):
    ref, mine = runs["ref"], runs["mine"]
    assert mine["steps"] == ref["steps"] == RUN["steps"]
    assert len(runs["ref_losses"]) == len(mine["losses"]) == RUN["steps"]
    np.testing.assert_allclose(mine["losses"], runs["ref_losses"], **TOL)
    np.testing.assert_allclose(mine["final_loss"], ref["final_loss"], **TOL)
    assert mine["test_acc"] == ref["test_acc"]
    # the final params, from each run's last checkpoint
    lcfg = BBitLinearConfig(k=RUN["k"], b=RUN["b"])
    template = init_state(_reference_start(lcfg, 0, "cpu"),
                          make_optimizer("adamw", RUN["lr"]))
    got, gstep = ckpt.restore(str(runs["base"] / "torch" / "ckpt"), template)
    want, wstep = ckpt.restore(str(runs["base"] / "jax" / "ckpt"), template)
    assert gstep == wstep == RUN["steps"]
    assert trees_bitwise_equal(got.params, mine["params"])
    for name in ("table", "bias"):
        np.testing.assert_allclose(got.params[name].numpy(),
                                   want.params[name].numpy(), **TOL)


def test_linear_mode_counts(runs):
    """On the CPU every call takes the plain versions: B1 per chunk, B7
    and B8 per step (plus the test-set forward), no kernel launched; the
    cost model has no profile, so every choice is a fallback."""
    c = runs["counts"]
    assert c["minhash_pack_plain"] == 1
    assert c["bbit_linear_bwd_dw_plain"] == RUN["steps"]
    assert c["bbit_linear_fwd_plain"] == RUN["steps"] + 1
    assert all(v == 0 for name, v in c.items()
               if not name.endswith("_plain"))
    rep = runs["report"]
    assert rep["hits"] == 0 and not rep["profile_loaded"]
    assert rep["fallbacks"] == 2 * RUN["steps"] + 1 + 1


def test_fail_at_resumes_bitwise(tmp_path, monkeypatch):
    """A crash injected at step 12 (after the checkpoint at step 10) and a
    rerun: the rerun resumes from step 10 and ends on the bits of an
    uninterrupted run."""
    monkeypatch.setattr(ttrain, "_initial_params", _reference_start)
    whole = ttrain.run_linear(_args(tmp_path / "whole"))
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        ttrain.run_linear(_args(tmp_path / "crash", fail_at=12))
    again = ttrain.run_linear(_args(tmp_path / "crash"))
    assert again["steps"] == whole["steps"]
    assert len(again["losses"]) == RUN["steps"] - 10
    assert again["losses"] == whole["losses"][10:]
    assert trees_bitwise_equal(again["params"], whole["params"])
    assert again["test_acc"] == whole["test_acc"]


def test_cli_linear_mode_in_a_subprocess(tmp_path, repo_src):
    env = dict(os.environ, PYTHONPATH=repo_src)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode",
           "linear", "--device", "cpu", "--workdir", str(tmp_path / "w"),
           "--n-docs", "120", "--k", "16", "--b", "16", "--steps", "8",
           "--batch-size", "16", "--ckpt-every", "4"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "preprocessed 120 docs" in proc.stdout
    assert "dispatch: static rules" in proc.stdout
    assert "final loss=" in proc.stdout and "test_acc=" in proc.stdout
    # a second run over the same workdir resumes at the end: no step left
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=600)
    assert again.returncode == 0, again.stdout + again.stderr
    assert "resumed from step 8" in again.stdout
    assert "preprocessed" not in again.stdout


def test_paper_config_is_the_reference():
    from repro.configs.rcv1_bbit import CONFIG as J
    from repro_torch.configs.rcv1_bbit import CONFIG
    import dataclasses
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(J)
    assert (dataclasses.asdict(CONFIG.linear_config())
            == dataclasses.asdict(J.linear_config()))
    assert (CONFIG.k, CONFIG.b) == (500, 16)
