"""Straggler accounting (a copy of the reference's ``ft/watchdog.py``)."""
