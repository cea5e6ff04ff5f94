"""One reader a metric: ``metrics/<name>.py`` defines ``read(run)``, which
returns the metric's value, or None where the run holds nothing to read."""
