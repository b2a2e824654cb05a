"""Share of TRON's Hessian products that reused their iterate's ℓ″:
``trainer.curvature_hits`` over hits and ``trainer.curvature_builds``
(ℓ″ computed) in the window; none where the program has neither counter
or made no product."""

HITS, BUILDS = "trainer.curvature_hits", "trainer.curvature_builds"


def read(rec):
    hits, builds = rec.counter(HITS), rec.counter(BUILDS)
    if not hits + builds:
        return None
    return 100.0 * hits / (hits + builds)
