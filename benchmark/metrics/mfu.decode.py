"""The whole ``inference`` call's share of the card's peak: the operations
of the requests traced (``counts.linear_inference``: decode, Gram matrix,
reconstruction) over the traced window's wall time times the peak."""

from benchmark.metrics import counts


def read(r):
    rows = r.counters.get("request_rows")
    if not rows:
        return None
    c = r.cfg
    S = counts.n_states(c["Hprime"], c["gamma"])
    flops = sum(counts.linear_inference(n, c["D"], c["H"], c["Hprime"], S,
                                        r.traffic["top_L"])["flops"]
                for n in rows)
    return 100.0 * flops / (r.trace.window_s * counts.PEAK_FLOPS[c["dtype"]])
