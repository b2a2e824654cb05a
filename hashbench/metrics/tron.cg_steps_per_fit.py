"""TRON's CG-Steihaug steps a fit (one Hessian-vector product each):
``tron.cg_steps`` over the window, over the fits."""


def read(rec):
    if "tron.cg_steps" not in rec.counters or not rec.calls:
        return None
    return rec.counter("tron.cg_steps") / rec.calls
