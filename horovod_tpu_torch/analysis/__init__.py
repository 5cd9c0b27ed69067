"""The port's own copy of the schedule verifier (``schedule.py``)."""
