"""Host microseconds of a call of ``encode_packed``: the harness's span
around each call, summed over the traced window, over the calls."""


def read(rec):
    calls, seconds = rec.spans.get("encode_packed", (0, 0.0))
    return 1e6 * seconds / calls if calls else None
