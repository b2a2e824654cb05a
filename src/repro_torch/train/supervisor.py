"""Supervised restart loop: run ``fit_streaming`` until it finishes
(counterpart of ``repro/train/supervisor.py``, single process).

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
escalations accumulate over the whole run.  The gang half of the
reference (``run_multiprocess_supervised``) waits for ROADMAP A5.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, List, Optional

from repro_torch.ft.retry import BackoffPolicy
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.train.streaming import StreamFitResult, fit_streaming

__all__ = ["RestartPolicy", "CrashRecord", "SupervisedRun",
           "run_supervised"]

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
