"""Host milliseconds ``EM.run_scanned`` spent capturing CUDA graphs in the
window (``EM.scan_stats["capture_s"]``), per training run that ran in it."""


def read(r):
    runs = r.counters.get("runs", 0)
    if not runs:
        return None
    return 1e3 * r.counters["capture_s"] / runs
