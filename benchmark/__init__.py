"""The port's benchmark: one run of one cell (``run.py``), the harness, the
traffic generator, the plain reference, the work counts and the metric
readers. See ``harness.py``."""
