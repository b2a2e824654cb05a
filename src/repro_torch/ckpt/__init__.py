"""Atomic, checksummed checkpoints and the serving handoff."""
