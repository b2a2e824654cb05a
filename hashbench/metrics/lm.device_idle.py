"""Share of the traced window with no kernel, copy or set on the device."""


def read(rec):
    return rec.idle_percent()
