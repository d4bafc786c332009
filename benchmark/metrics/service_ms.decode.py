"""The median time a decode request took from the start of its call to
its outputs synchronised on the device (host clock), without the time it
waited in the queue."""

import statistics


def read(r):
    s = r.counters.get("service_s")
    if not s:
        return None
    return 1e3 * statistics.median(s)
