"""Host microseconds of the output allocation of B1's or B2's launch (the
program's span ``kernel.alloc``, traced run) a call of ``encode_packed``
(its span's calls); none where no kernel launched."""


def read(rec):
    calls = rec.counter("span.scheme.encode_packed.calls")
    if not calls or not rec.counter("span.kernel.alloc.calls"):
        return None
    return rec.counter("span.kernel.alloc.ns") * 1e-3 / calls
