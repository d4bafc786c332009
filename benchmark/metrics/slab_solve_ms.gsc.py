"""Device ms an iteration in GSC's ``slab_solve`` regions (the small
Cholesky factors, solves and inverses of every support, each chunk of
rows), from ``EM.scan_stats["layer_ms"]`` over the iterations timed."""


def read(r):
    ms = r.counters.get("layer_ms", {}).get("slab_solve")
    n = r.counters.get("timed_iterations", 0)
    return ms / n if ms and n else None
