"""Calls of any operation that took its plain torch arm over the window
(every ``*_plain`` counter of ``ops.counts()``); 0 on the main path."""


def read(rec):
    return rec.plain_calls()
