"""A state axis of n shards in one process, for the port's tests.

``run_state_shards(n, fn)`` calls ``fn(state_axis)`` in n threads, one per
state rank, where ``state_axis`` stands in for a row's state group: while
they run, ``prosper_tpu_torch.parallel.mesh`` sees a ``torch.distributed``
whose process groups are these stand-ins, and an all-reduce over one
deposits each rank's tensor, waits for all of them, and gives every rank
the reduction in rank order (the same bits on every rank, as gloo and NCCL
give).  The port's own code paths run unchanged: the slices, the masks,
the MAX and SUM combines and the sums counted on state rank 0.

Not collected by pytest (the file name does not start with ``test_``).
"""

import threading
import types

import torch
import torch.distributed as dist

from prosper_tpu_torch.parallel import mesh


class StateRank:
    """State rank ``rank`` of a ``_Row``: what the code under test gets as
    ``state_axis``."""

    def __init__(self, row: "_Row", rank: int):
        self.row, self.rank = row, rank


class _Row:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.calls = [0] * n

    def all_reduce(self, member: StateRank, x: torch.Tensor, op) -> None:
        self.calls[member.rank] += 1
        self.slots[member.rank] = x.clone()
        self.barrier.wait()
        out = self.slots[0]
        for t in self.slots[1:]:
            out = torch.maximum(out, t) if op == dist.ReduceOp.MAX else out + t
        self.barrier.wait()
        x.copy_(out)


_SHIM = types.SimpleNamespace(
    ProcessGroup=StateRank, ReduceOp=dist.ReduceOp,
    get_rank=lambda g: g.rank, get_world_size=lambda g: g.row.n,
    all_reduce=lambda x, op, group: group.row.all_reduce(group, x, op))


def run_state_shards(n: int, fn):
    """[fn(state rank r) for r in range(n)], run concurrently; also the
    number of all-reduces each rank issued.  Raises the first error a rank
    raised (the others are released)."""
    row = _Row(n)
    out, errors = [None] * n, []

    def work(r):
        try:
            out[r] = fn(StateRank(row, r))
        except BaseException as e:        # noqa: BLE001 - handed back below
            errors.append(e)
            row.barrier.abort()

    real, mesh.dist = mesh.dist, _SHIM
    try:
        threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        mesh.dist = real
    if errors:
        raise errors[0]
    return out, row.calls
