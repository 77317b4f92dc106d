"""Metric readers: ``<name>.py`` reads metric ``<name>`` (and
``<name>.<suffix>``) from a run's ``Record`` with ``read(rec, suffix)``,
which returns the value, or None where the run has nothing to read."""
