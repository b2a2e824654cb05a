"""One reader a per-layer metric, ``<metric>.py`` with ``read(rec) ->
float | None`` over a ``trace.Record``; None where the run has nothing
to read, and the harness then leaves the metric out."""
