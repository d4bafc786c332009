"""The linear E-step's share of its roofline: the least time of its work at
the cell's rows (``counts.linear_estep``) times the iterations traced, over
the device time of the kernels that carry it (the per-datapoint kernel, the
two GEMMs, the in-order sums)."""

from benchmark.metrics import counts


def read(r):
    if not r.trace.has("estep.linear"):
        return None
    c = r.cfg
    work = counts.linear_estep(r.counters["rows"], c["D"], c["H"],
                               c["Hprime"],
                               counts.n_states(c["Hprime"], c["gamma"]))
    least = r.counters["iterations"] * counts.least_seconds(work, c["dtype"])
    return 100.0 * least / r.trace.seconds("estep.linear", "gemm", "reduce")
