"""Fault tolerance: deterministic fault injection, rank-scoped across a
gang (``faults``), capped exponential retry backoff (``retry``) and
straggler accounting (``watchdog``), copies of the reference's."""
