"""Host milliseconds of one cached decode step: the program's span
``lm.decode_step`` (it records under the traced run's profiler), its
total over the window over its calls."""


def read(rec):
    calls = rec.counter("span.lm.decode_step.calls")
    if not calls:
        return None
    return 1e-6 * rec.counter("span.lm.decode_step.ns") / calls
