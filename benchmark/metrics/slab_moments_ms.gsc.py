"""Device ms an iteration in GSC's ``slab_moments`` regions (<sz> and
<sz sz^T> in the candidate frame, their scatter to H and ``slot_sum_ss``,
each chunk of rows), from ``EM.scan_stats["layer_ms"]`` over the
iterations timed."""


def read(r):
    ms = r.counters.get("layer_ms", {}).get("slab_moments")
    n = r.counters.get("timed_iterations", 0)
    return ms / n if ms and n else None
