"""TRON's outer iterations a fit (``FitResult.n_iter``), the window's mean."""


def read(rec):
    n = rec.values.get("n_iter")
    return sum(n) / len(n) if n else None
