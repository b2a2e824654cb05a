"""Host milliseconds of a fit's accuracy pass (its predictions over the
training and test codes and their accuracies): the program's span
``trainer.accuracy``, which records in a traced run, over the fits."""


def read(rec):
    if not rec.counter("span.trainer.accuracy.calls") or not rec.calls:
        return None
    return rec.counter("span.trainer.accuracy.ns") * 1e-6 / rec.calls
