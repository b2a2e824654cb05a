"""Capped exponential backoff with deterministic jitter (a copy of the
reference's ``ft/retry.py``; the port imports nothing of ``repro``).

One definition for every retry loop of the port: the supervised restart
policy (``train.supervisor``) and the transient-shard-read retries
(``data.hashed_dataset``).  Jitter is a pure function of
``(seed, attempt)`` (``np.random.SeedSequence``), so retry timing is
reproducible run to run, and equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BackoffPolicy"]


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """``delay_s(attempt)`` = min(cap, base·factor^attempt), jittered
    by ±``jitter_frac`` deterministically from ``(seed, attempt)``."""
    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 2.0
    jitter_frac: float = 0.1
    seed: int = 0

    def delay_s(self, attempt: int) -> float:
        d = min(float(self.cap_s),
                float(self.base_s) * float(self.factor) ** int(attempt))
        if self.jitter_frac:
            u = np.random.default_rng(
                np.random.SeedSequence((int(self.seed),
                                        int(attempt)))).random()
            d *= 1.0 + float(self.jitter_frac) * (2.0 * u - 1.0)
        return d
