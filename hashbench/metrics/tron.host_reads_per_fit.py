"""TRON's host reads of the card a fit: ``tron.host_reads`` (each scalar
test of its outer and inner loops, ``optim/tron.py::_read``) over the
window, over the fits."""


def read(rec):
    if "tron.host_reads" not in rec.counters or not rec.calls:
        return None
    return rec.counter("tron.host_reads") / rec.calls
