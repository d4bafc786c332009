"""The whole GSC EM step's share of the card's peak: the operations of the
iterations in the traced window (E-step and the five-parameter M-step,
``counts_gsc.train_iteration``) over the window's wall time times the
peak of the configuration's precision."""

from benchmark.metrics import counts, counts_gsc


def read(r):
    n = r.counters.get("iterations", 0)
    if not n:
        return None
    flops = n * counts_gsc.train_iteration(r.cfg, r.counters["rows"])["flops"]
    return 100.0 * flops / (r.trace.window_s
                            * counts.PEAK_FLOPS[r.cfg["dtype"]])
