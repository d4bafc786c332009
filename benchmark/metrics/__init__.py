"""Per-layer metrics: one reader a metric (``<metric>.py``, a function
``read(reading)`` that returns the number, or None where the run has
nothing for it to read), the count functions and peaks (``counts.py``) and
the table of the program's kernels (``kernels.json``)."""
