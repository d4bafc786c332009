"""Device milliseconds per EM iteration of the collectives (NCCL's
kernels) on rank 0: the all-reduce of the step's sums and the data cut's
reductions, from the traced replays."""


def read(r):
    if r.chips < 2 or not r.trace.has("allreduce"):
        return None
    return 1e3 * r.trace.seconds("allreduce") / r.counters["iterations"]
