"""Fault tolerance: deterministic fault injection (``faults``), capped
exponential retry backoff (``retry``) and straggler accounting
(``watchdog``), copies of the reference's single-process parts."""
