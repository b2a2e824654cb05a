"""Share of B8's calls served a kept plan: ``bbit_linear_bwd_dw_plan_hits``
over hits and ``bbit_linear_bwd_dw_plans`` (plans built) in the window;
none where B8 took no plan (the plain version)."""

HITS, BUILDS = "bbit_linear_bwd_dw_plan_hits", "bbit_linear_bwd_dw_plans"


def read(rec):
    hits, builds = rec.counter(HITS), rec.counter(BUILDS)
    if HITS not in rec.counters or not hits + builds:
        return None
    return 100.0 * hits / (hits + builds)
