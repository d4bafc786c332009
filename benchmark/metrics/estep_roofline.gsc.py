"""The GSC E-step's share of its roofline: the least time of its work at
the cell's rows (``counts_gsc.gsc_estep``) times the iterations timed, over
the device time of the ``estep`` region of the captured steps
(``EM.scan_stats["layer_ms"]``, spans on): GSC has no per-datapoint kernel,
so the region's small kernels together carry the work."""

from benchmark.metrics import counts, counts_gsc


def read(r):
    ms = r.counters.get("layer_ms", {}).get("estep")
    n = r.counters.get("timed_iterations", 0)
    if not ms or not n:
        return None
    c = r.cfg
    work = counts_gsc.gsc_estep(r.counters["rows"], c["D"], c["H"],
                                c["Hprime"], c["gamma"])
    return 100.0 * n * counts.least_seconds(work, c["dtype"]) / (1e-3 * ms)
