"""Host microseconds of an ``encode_packed`` call measured inside the
program: its span ``scheme.encode_packed`` (traced run), over its
calls."""


def read(rec):
    calls = rec.counter("span.scheme.encode_packed.calls")
    if not calls:
        return None
    return rec.counter("span.scheme.encode_packed.ns") * 1e-3 / calls
