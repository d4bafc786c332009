"""The benchmark of prosper_tpu_torch, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last.  Everything here is found by name from ``BENCHMARK.json``:
a configuration is ``configs/<config>.json``, a traffic mix is
``traffic/<traffic>.json`` (read by the driver ``drivers/<kind>.py`` that
its ``kind`` names), a per-layer metric is the reader
``metrics/<metric>.py``, and a cell's limits for ``correct`` are
``limits/<cell>.json``.  The plain reference (``reference.py``) and the
data generator (``data.py``) import nothing of the program.
"""
