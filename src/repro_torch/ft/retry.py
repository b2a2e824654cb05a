"""Capped exponential backoff with deterministic jitter (a copy of the
reference's ``ft/retry.py``; the port imports nothing of ``repro``).

One definition for every retry loop of the port: the supervised restart
policy and the gang's per-rank restart stagger (``train.supervisor``)
and the transient-shard-read retries (``data.hashed_dataset``).  Jitter
is a pure function of ``(seed, attempt)`` (``np.random.SeedSequence``),
so retry timing is reproducible run to run, and equal to the
reference's.
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

    def for_rank(self, rank: int) -> "BackoffPolicy":
        """A copy whose jitter stream is de-correlated for gang rank
        ``rank`` (same base, factor and cap): a gang restart relaunches
        every worker at once, and one shared stream would keep their
        retries in lockstep.  The rank's seed comes from
        ``SeedSequence((seed, 0x5eed, rank))``, not ``seed + rank``, so
        neighbouring ranks get unrelated streams."""
        derived = int(np.random.SeedSequence(
            (int(self.seed), 0x5eed, int(rank))).generate_state(1)[0])
        return dataclasses.replace(self, seed=derived)
