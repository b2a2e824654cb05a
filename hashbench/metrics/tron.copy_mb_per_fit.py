"""Megabytes (1e6 bytes) the trainer copies between host and card a fit:
``trainer.h2d_bytes`` (host inputs moved to the card) and
``trainer.d2h_bytes`` (predictions and labels copied for the accuracy
pass) over the window, over the fits."""

NAMES = ("trainer.h2d_bytes", "trainer.d2h_bytes")


def read(rec):
    if any(n not in rec.counters for n in NAMES) or not rec.calls:
        return None
    return rec.counter(*NAMES) / rec.calls / 1e6
