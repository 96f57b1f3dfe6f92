"""Metric readers: <metric name>.py has read(run) -> value or None (run.Run)."""
