"""Closed-form estimators and variance laws from the paper (a copy of
``repro/core/estimators.py``: numpy only).

Every formula the paper states is implemented here as a pure function
and property-tested against Monte-Carlo simulation of the hashing code
(``tests/test_estimators.py`` for the reference,
``tests/test_torch_estimators.py`` for this copy):

  Eq. (1)/(2)   minwise estimator R̂_M and its variance
  Theorem 1 / Eq. (3)-(5)  b-bit collision law P_b = C1 + (1-C2)·R
  Eq. (6)/(7)   R̂_b from P̂_b and Var(R̂_b)
  Eq. (13)      random-projection variance (general s)
  Eq. (16)      VW variance (general s) — equals (13) at s=1
"""
from __future__ import annotations

import dataclasses

import numpy as np


# -- minwise hashing (paper §2) ---------------------------------------------
def var_rm(R: float, k: int) -> float:
    """Var(R̂_M) = R(1-R)/k (paper Eq. 2)."""
    return R * (1.0 - R) / k


# -- b-bit minwise hashing (Theorem 1) --------------------------------------
@dataclasses.dataclass(frozen=True)
class BBitLaw:
    """The constants of Theorem 1 for a pair with sparsities r1, r2."""

    b: int
    r1: float
    r2: float

    @property
    def A1(self) -> float:
        return _A(self.r1, self.b)

    @property
    def A2(self) -> float:
        return _A(self.r2, self.b)

    @property
    def C1(self) -> float:
        r1, r2 = self.r1, self.r2
        if r1 + r2 == 0.0:            # the r→0 limit (paper Eq. 4)
            return 0.5 * (self.A1 + self.A2)
        return self.A1 * r2 / (r1 + r2) + self.A2 * r1 / (r1 + r2)

    @property
    def C2(self) -> float:
        r1, r2 = self.r1, self.r2
        if r1 + r2 == 0.0:
            return 0.5 * (self.A1 + self.A2)
        return self.A1 * r1 / (r1 + r2) + self.A2 * r2 / (r1 + r2)

    def pb(self, R: float) -> float:
        """P_b = C1 + (1 - C2)·R (paper Eq. 3)."""
        return self.C1 + (1.0 - self.C2) * R

    def r_hat(self, pb_hat: float) -> float:
        """R̂_b = (P̂_b - C1)/(1 - C2) (paper Eq. 6)."""
        return (pb_hat - self.C1) / (1.0 - self.C2)

    def var_rb(self, R: float, k: int) -> float:
        """Var(R̂_b) (paper Eq. 7)."""
        pb = self.pb(R)
        return pb * (1.0 - pb) / (k * (1.0 - self.C2) ** 2)


def _A(r: float, b: int) -> float:
    if r == 0.0:
        return 1.0 / (1 << b)  # the r→0 limit (paper Eq. 4)
    q = (1.0 - r) ** (1 << b)
    return r * (1.0 - r) ** ((1 << b) - 1) / (1.0 - q)


def bbit_law_sparse_limit(b: int):
    """The r1,r2→0 limit: P_b = 1/2^b + (1 - 1/2^b)·R (paper Eq. 5)."""
    inv = 1.0 / (1 << b)

    def pb(R: float) -> float:
        return inv + (1.0 - inv) * R

    return pb


# -- random projections (paper §5.1) ----------------------------------------
def var_rp(u1: np.ndarray, u2: np.ndarray, k: int, s: float = 1.0) -> float:
    """Var(â_rp,s) (paper Eq. 13)."""
    m1 = float(np.sum(u1 * u1))
    m2 = float(np.sum(u2 * u2))
    a = float(np.sum(u1 * u2))
    cross = float(np.sum((u1 * u2) ** 2))
    return (m1 * m2 + a * a + (s - 3.0) * cross) / k


# -- VW (paper §5.2) ---------------------------------------------------------
def var_vw(u1: np.ndarray, u2: np.ndarray, k: int, s: float = 1.0) -> float:
    """Var(â_vw,s) (paper Eq. 16); equals Eq. 13 at s=1."""
    m1 = float(np.sum(u1 * u1))
    m2 = float(np.sum(u2 * u2))
    a = float(np.sum(u1 * u2))
    cross = float(np.sum((u1 * u2) ** 2))
    return (s - 1.0) * cross + (m1 * m2 + a * a - 2.0 * cross) / k


def storage_equivalent_k_vw(k_bbit: int, b: int,
                            bits_per_vw_entry: int = 32) -> int:
    """VW bins affordable at the same storage as (k_bbit, b) codes."""
    return max(1, (k_bbit * b) // bits_per_vw_entry)
