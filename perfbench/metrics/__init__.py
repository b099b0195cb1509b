"""One reader a metric, `<metric name>.py`, loaded by file: `read(run)`
returns the metric's value from a run's record, or None where it finds
nothing to read."""
