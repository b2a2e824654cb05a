"""Supervised restart loops: run ``fit_streaming`` until it finishes,
in one process or as a gang of processes (counterpart of
``repro/train/supervisor.py``).

A crash (injected or real) kills the fit mid-shard; the supervisor waits
out a capped exponential backoff (deterministic jitter,
``ft.retry.BackoffPolicy``) and calls ``fit_streaming`` again with
``resume=True``: the trainer restores the newest valid checkpoint
(torn or corrupt ones are quarantined, ``ckpt.checkpoint``) and replays
the stream from that boundary.  Batch replay is a pure function of
``(seed, epoch, position)``, so the supervised run ends bit-identical to
an uninterrupted one.

Any exception counts as a crash, a kernel's failure included, except

  * ``ValueError``: a configuration or compatibility error, which a
    retry can only repeat, so it propagates at once;
  * ``KeyboardInterrupt`` / ``SystemExit``: the operator, not a fault.

One ``StepWatchdog`` rides along across restarts, so straggler
escalations accumulate over the whole run.

``run_multiprocess_supervised`` is the gang half: it starts ``procs``
workers (``python -m repro_torch.train.worker``, each a fresh
interpreter joined through ``torch.distributed``), watches them, and on
the first worker death kills the whole gang and starts it again from
the newest valid coordinated checkpoint (``ckpt.coordinated``): a dead
rank cannot rejoin a live group.  Each attempt binds a fresh coordinator
port; restarts are staggered per rank (``BackoffPolicy.for_rank``), so
a gang restart does not relaunch every rank at the same instant.  Exit
code 64 from any worker is the configuration-error protocol
(``train.worker``): raised as ``ValueError``, never retried.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.ft.retry import BackoffPolicy
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.train.streaming import StreamFitResult, fit_streaming
from repro_torch.train.worker import CONFIG_ERROR_EXIT

__all__ = ["RestartPolicy", "CrashRecord", "SupervisedRun",
           "run_supervised", "MultiProcessRun",
           "run_multiprocess_supervised"]

log = logging.getLogger("repro_torch.train.supervisor")


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """At most ``max_restarts`` restarts, each after
    ``backoff.delay_s(attempt)``."""
    max_restarts: int = 3
    backoff: BackoffPolicy = BackoffPolicy(base_s=0.05, factor=2.0,
                                           cap_s=5.0, jitter_frac=0.1)


@dataclasses.dataclass
class CrashRecord:
    """One supervised crash: the restart that followed it, what died, and
    the recovery's seconds (backoff, restore, replay to the crash)."""
    restart: int
    error: str
    backoff_s: float
    recover_s: float = 0.0


@dataclasses.dataclass
class SupervisedRun:
    result: StreamFitResult
    restarts: int
    crashes: List[CrashRecord]
    watchdog: StepWatchdog

    @property
    def straggler_escalations(self) -> int:
        return len(self.watchdog.escalations)


def run_supervised(root: str, cfg: Any, *,
                   policy: Optional[RestartPolicy] = None,
                   watchdog: Optional[StepWatchdog] = None,
                   **fit_kwargs) -> SupervisedRun:
    """Runs ``fit_streaming(root, cfg, **fit_kwargs)`` under restart
    supervision → the finished result and the crash accounting.

    ``ckpt_dir`` is required (without checkpoints a restart would start
    over); ``resume`` is forced True on every attempt, the first
    included."""
    if not fit_kwargs.get("ckpt_dir"):
        raise ValueError(
            "run_supervised requires ckpt_dir: without checkpoints a "
            "restart cannot resume and would retrain from scratch")
    if fit_kwargs.get("resume") is False:
        raise ValueError(
            "run_supervised forces resume=True — a supervised restart "
            "that refuses its own checkpoints cannot recover")
    fit_kwargs["resume"] = True
    policy = RestartPolicy() if policy is None else policy
    watchdog = StepWatchdog() if watchdog is None else watchdog
    crashes: List[CrashRecord] = []
    attempt = 0
    while True:
        t_try = time.perf_counter()
        try:
            result = fit_streaming(root, cfg, watchdog=watchdog,
                                   **fit_kwargs)
        except (KeyboardInterrupt, SystemExit):
            raise
        except ValueError:
            # a configuration or compatibility error: not a crash
            raise
        except Exception as e:  # noqa: BLE001 — the supervised surface
            if crashes:
                crashes[-1].recover_s += time.perf_counter() - t_try
            if attempt >= policy.max_restarts:
                log.error(
                    "giving up after %d restarts (%d crashes); last "
                    "error: %r", attempt, len(crashes) + 1, e)
                raise
            delay = policy.backoff.delay_s(attempt)
            log.warning(
                "training attempt %d crashed (%r) — restarting from "
                "the latest valid checkpoint in %.3fs "
                "(restart %d/%d)", attempt + 1, e, delay, attempt + 1,
                policy.max_restarts)
            crashes.append(CrashRecord(restart=attempt + 1,
                                       error=repr(e), backoff_s=delay))
            time.sleep(delay)
            attempt += 1
            continue
        if crashes:
            crashes[-1].recover_s += time.perf_counter() - t_try
        return SupervisedRun(result=result, restarts=attempt,
                             crashes=crashes, watchdog=watchdog)


# ------------------------------------------------ multi-process gang ----

@dataclasses.dataclass
class MultiProcessRun:
    """A finished gang run: each rank's result record (rank → the dict
    ``train.worker`` wrote), the restart and crash accounting, where each
    rank left its final params (``params_paths[rank]``, ``p<i>`` and
    ``a<i>`` leaves), and each attempt's seconds."""
    results: Dict[int, dict]
    params_paths: Dict[int, str]
    restarts: int
    crashes: List[CrashRecord]
    run_dir: str
    attempt_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def result(self) -> dict:
        return self.results[0]


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _src_root() -> str:
    # <src>/repro_torch/train/supervisor.py → <src>: workers import the
    # same tree whatever the caller's working directory
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _kill_gang(children) -> None:
    for p in children:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGKILL)
            except OSError:
                pass
    for p in children:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _tail(path: str, n: int = 12) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def run_multiprocess_supervised(
    root: str,
    cfg: Any,
    *,
    procs: int,
    run_dir: str,
    policy: Optional[RestartPolicy] = None,
    fault_spec: Optional[dict] = None,
    local_devices: int = 1,
    attempt_timeout_s: float = 600.0,
    **fit_kwargs,
) -> MultiProcessRun:
    """Runs ``fit_streaming(root, cfg, **fit_kwargs)`` as a
    ``procs``-process gang under gang-restart supervision.

    Each attempt binds a fresh coordinator port, writes one JSON spec a
    rank under ``run_dir`` and starts ``python -m
    repro_torch.train.worker`` for each rank (``local_devices`` devices
    a rank; ``fit_kwargs["device"]`` names the device type, and rank r
    takes ``cuda:(r mod cards)``).  The first non-zero exit kills the
    whole gang and, within ``policy.max_restarts``, starts it again;
    every worker resumes from the newest valid coordinated checkpoint,
    so the finished gang's params are bit-identical to an uninterrupted
    run's.  An attempt that outlives ``attempt_timeout_s`` is killed and
    counts as a crash.  ``fault_spec`` (``FaultPlan.to_spec``) ships a
    rank-scoped fault plan to every worker; firing counts persist a rank
    under ``run_dir``.
    """
    if procs < 1:
        raise ValueError(f"procs must be >= 1, got {procs}")
    if not fit_kwargs.get("ckpt_dir"):
        raise ValueError(
            "run_multiprocess_supervised requires ckpt_dir: a gang "
            "restart without checkpoints would retrain from scratch")
    if fit_kwargs.get("resume") is False:
        raise ValueError(
            "run_multiprocess_supervised forces resume=True — a gang "
            "restart that refuses its own checkpoints cannot recover")
    fit_kwargs["resume"] = True
    if fit_kwargs.get("device") is not None:
        fit_kwargs["device"] = str(fit_kwargs["device"])
    policy = RestartPolicy() if policy is None else policy
    os.makedirs(run_dir, exist_ok=True)
    cfg_dict = dataclasses.asdict(cfg)
    env = dict(os.environ)
    env["PYTHONPATH"] = (_src_root() + os.pathsep
                         + env.get("PYTHONPATH", ""))

    crashes: List[CrashRecord] = []
    attempt_s: List[float] = []
    attempt = 0
    while True:
        coordinator = f"127.0.0.1:{_free_port()}"
        children, logs = [], []
        for r in range(procs):
            spec = {"root": root, "cfg": cfg_dict, "fit": fit_kwargs,
                    "procs": procs, "rank": r,
                    "coordinator": coordinator,
                    "local_devices": int(local_devices),
                    "run_dir": run_dir, "fault_spec": fault_spec,
                    "fault_state": os.path.join(
                        run_dir, f"fault_state_rank{r}.json"),
                    "result_path": os.path.join(
                        run_dir, f"result_rank{r}.json"),
                    "params_path": os.path.join(
                        run_dir, f"params_rank{r}.npz")}
            spec_path = os.path.join(run_dir, f"spec_rank{r}.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            if attempt > 0:
                # a per-rank stagger: a gang restart must not relaunch
                # every rank at the same instant
                time.sleep(policy.backoff.for_rank(r)
                           .delay_s(attempt - 1))
            log_path = os.path.join(run_dir,
                                    f"log_rank{r}_try{attempt}.txt")
            logs.append(log_path)
            with open(log_path, "w") as lf:
                # a fresh interpreter, never a fork of this process
                children.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.train.worker",
                     "--spec", spec_path],
                    env=env, stdout=lf, stderr=subprocess.STDOUT,
                    close_fds=True))

        t_try = time.perf_counter()
        failure: Optional[str] = None
        while True:
            codes = [p.poll() for p in children]
            bad = [(r, c) for r, c in enumerate(codes)
                   if c not in (None, 0)]
            if bad:
                r, c = bad[0]
                if c == CONFIG_ERROR_EXIT:
                    _kill_gang(children)
                    raise ValueError(
                        f"gang rank {r} reported a configuration "
                        f"error (exit {c}):\n{_tail(logs[r])}")
                failure = (f"rank {r} died with "
                           + (f"signal {-c}" if c < 0 else f"exit {c}"))
                break
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() - t_try > attempt_timeout_s:
                failure = (f"gang attempt timed out after "
                           f"{attempt_timeout_s:.0f}s")
                break
            time.sleep(0.02)
        attempt_s.append(time.perf_counter() - t_try)
        if failure is None:
            if crashes:
                crashes[-1].recover_s += attempt_s[-1]
            results, params = {}, {}
            for r in range(procs):
                with open(os.path.join(run_dir,
                                       f"result_rank{r}.json")) as f:
                    results[r] = json.load(f)
                params[r] = os.path.join(run_dir, f"params_rank{r}.npz")
            return MultiProcessRun(results=results, params_paths=params,
                                   restarts=attempt, crashes=crashes,
                                   run_dir=run_dir, attempt_s=attempt_s)
        _kill_gang(children)
        if crashes:
            crashes[-1].recover_s += attempt_s[-1]
        if attempt >= policy.max_restarts:
            raise RuntimeError(
                f"gang gave up after {attempt} restarts: {failure}\n"
                + _tail(logs[0]))
        delay = policy.backoff.delay_s(attempt)
        log.warning("gang attempt %d failed (%s) — restarting in "
                    "%.3fs (restart %d/%d)", attempt + 1, failure,
                    delay, attempt + 1, policy.max_restarts)
        crashes.append(CrashRecord(restart=attempt + 1, error=failure,
                                   backoff_s=delay))
        time.sleep(delay)
        attempt += 1
