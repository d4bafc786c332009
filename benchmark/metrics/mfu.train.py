"""The whole EM step's share of the card's peak: the operations of the
iterations traced (E-step and M-step, ``counts.train_iteration``; nothing
recomputed counts) over the traced window's wall time times the peak of
the configuration's precision."""

from benchmark.metrics import counts


def read(r):
    n = r.counters.get("iterations", 0)
    if not n:
        return None
    flops = n * counts.train_iteration(r.cfg, r.counters["rows"])["flops"]
    return 100.0 * flops / (r.trace.window_s
                            * counts.PEAK_FLOPS[r.cfg["dtype"]])
