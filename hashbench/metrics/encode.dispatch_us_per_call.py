"""Host microseconds of the cost model's choice of arm (``perf.choose``,
the program's span ``dispatch.choose``, traced run) a call of
``encode_packed`` (its span's calls)."""


def read(rec):
    calls = rec.counter("span.scheme.encode_packed.calls")
    if not calls or not rec.counter("span.dispatch.choose.calls"):
        return None
    return rec.counter("span.dispatch.choose.ns") * 1e-3 / calls
