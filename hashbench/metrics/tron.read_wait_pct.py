"""Share of the window's host time spent in TRON's host reads of the card
(the program's span ``tron.read``, which records in a traced run): the
host blocked while the card finishes the work a read waits for."""


def read(rec):
    if not rec.counter("span.tron.read.calls") or rec.wall_s <= 0:
        return None
    return 100.0 * rec.counter("span.tron.read.ns") * 1e-9 / rec.wall_s
