"""The decode's share of its roofline: the least time of the decodes of
the requests traced (``counts.linear_decode``), over the device time of
their kernels (the per-datapoint decode kernel and the GEMM P = y W)."""

from benchmark.metrics import counts


def read(r):
    if not r.trace.has("decode"):
        return None
    c = r.cfg
    S = counts.n_states(c["Hprime"], c["gamma"])
    least = sum(counts.least_seconds(
        counts.linear_decode(n, c["D"], c["H"], c["Hprime"], S,
                             r.traffic["top_L"]), c["dtype"])
        for n in r.counters["request_rows"])
    return 100.0 * least / r.trace.seconds("decode", "gemm")
