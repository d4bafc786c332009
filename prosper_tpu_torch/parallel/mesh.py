"""The data-parallel runtime on ``torch.distributed``.

Counterpart of ``prosper_tpu/parallel/mesh.py``.  The reference runs under
``mpirun -n P``: each rank loads its ``stride_data`` rows, the summed
sufficient statistics are all-reduced, and every rank computes the same
closed-form M-step.  Here that is one process per device (rank r drives
``cuda:{LOCAL_RANK}``, started by ``torchrun`` or ``init_multihost``): the
parameters are replicated, each rank holds its own rows, and the model
steps reduce over a process group where the JAX package names a mesh axis.
NCCL reduces device tensors on the card; gloo serves the CPU and can reduce
CUDA tensors too (through the host).

Without a group the ``maybe_*`` collectives are the identity, so a run with
no runtime issues no collective.  With a group they are issued even at
world size 1, whose all-reduce leaves every bit as it is: a one-rank run
under a runtime equals the run without one bit for bit.

A ``("data", "state")`` mesh of ``n_data x n_state`` ranks (SURVEY.md
§5.7's sequence-parallel analogue) lays the ranks out row-major: rank r is
``(d, s) = divmod(r, n_state)``.  The ranks of one row (one data index)
hold the same rows and split the enumerated multi states into ``n_state``
contiguous slices; the E-steps combine their partial softmaxes over the
row's state group (a MAX of the row maxima, a SUM of the rescaled masses)
and the sufficient statistics are summed over both groups.  The ranks of
one column (one state index) are a data-parallel group as above.
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from prosper_tpu_torch.utils import process_count, process_index
from prosper_tpu_torch.utils.staging import rows_to_device

# ---------------------------------------------------------------------------
# Collectives that are the identity without a group
# ---------------------------------------------------------------------------

#: the all-reduces of device tensors the steps issued (host calls: a CUDA
#: graph's capture counts its collectives once, its replays not at all)
COLLECTIVES: Dict[str, int] = {"all_reduce": 0}


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return x
    # gloo takes no 0-d tensor; the 1-element view is reduced in place
    _all_reduce(x.view(-1), group, op)
    return x


def maybe_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of ``group`` (in place); identity if None."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def maybe_pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Maximum over the ranks of ``group`` (in place); identity if None."""
    return _reduce(x, group, dist.ReduceOp.MAX)


def maybe_pmin(x: torch.Tensor, group=None) -> torch.Tensor:
    """Minimum over the ranks of ``group`` (in place); identity if None."""
    return _reduce(x, group, dist.ReduceOp.MIN)


#: entries of a flattened buffer start at multiples of this many elements
#: (512 bytes for float32, the caching allocator's alignment), so that every
#: view takes the same kernels as a tensor of its own would
_ALIGN = 128


def psum_dict(tree: Dict[str, torch.Tensor], group=None
              ) -> Dict[str, torch.Tensor]:
    """Sum every tensor of ``tree`` over ``group`` with one all-reduce per
    dtype: the tensors are copied into one buffer, reduced, and returned as
    views of it (each of its own shape).  One collective per step costs less
    than one per key and fixes the order of the reduction.  Identity if
    ``group`` is None."""
    if group is None:
        return tree
    out: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(v.dtype for v in tree.values()):
        keys = [k for k, v in tree.items() if v.dtype == dtype]
        offs, total = [], 0
        for k in keys:
            offs.append(total)
            total += -(-tree[k].numel() // _ALIGN) * _ALIGN
        device = tree[keys[0]].device
        buf = torch.zeros(total, dtype=dtype, device=device)
        for k, o in zip(keys, offs):
            buf[o:o + tree[k].numel()].copy_(tree[k].reshape(-1))
        _all_reduce(buf, group)
        for k, o in zip(keys, offs):
            out[k] = buf[o:o + tree[k].numel()].view(tree[k].shape)
    return {k: out[k] for k in tree}


# ---------------------------------------------------------------------------
# Host-side helpers (reference: pprint / stride_data)
# ---------------------------------------------------------------------------


def state_sharded(state_axis, n_state_shards: int) -> bool:
    """Whether a step runs on a slice of the enumerated states: with a
    state group and more than one state shard, as in the JAX package.
    ``n_state_shards > 1`` without a group is a ValueError."""
    if int(n_state_shards) <= 1:
        return False
    if not isinstance(state_axis, dist.ProcessGroup):
        raise ValueError(
            f"n_state_shards={n_state_shards} needs the state group "
            f"(state_axis, a torch.distributed process group), got "
            f"{state_axis!r}; MeshRuntime.shard_step binds it")
    if dist.get_world_size(state_axis) != int(n_state_shards):
        raise ValueError(
            f"n_state_shards={n_state_shards}, but the state group has "
            f"{dist.get_world_size(state_axis)} ranks")
    return True


def state_rank(state_axis) -> int:
    """This rank's index on the state axis (its rank in the state group)."""
    return dist.get_rank(state_axis)


def grid_groups(mesh_shape: Tuple[int, int]
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """The mesh ranks of each column (the data group of state index s:
    ranks d * n_state + s) and of each row (the state group of data index
    d), for a row-major ``(n_data, n_state)`` grid."""
    n_data, n_state = (int(v) for v in mesh_shape)
    cols = [[d * n_state + s for d in range(n_data)] for s in range(n_state)]
    rows = [[d * n_state + s for s in range(n_state)] for d in range(n_data)]
    return cols, rows


def pprint(*args, **kwargs) -> None:
    """Print only on rank 0 (reference: utils/parallel.py::pprint)."""
    if process_index() == 0:
        print(*args, **kwargs)


def stride_data(N: int, parts: Optional[int] = None,
                index: Optional[int] = None) -> Tuple[int, int]:
    """(first, last) bounds of this rank's contiguous shard of N
    datapoints (reference: utils/parallel.py::stride_data): the first
    N % parts ranks hold one row more.  The rank and count come from
    ``torch.distributed`` when it is initialised."""
    parts = process_count() if parts is None else parts
    index = process_index() if index is None else index
    base, rem = divmod(N, parts)
    first = index * base + min(index, rem)
    last = first + base + (1 if index < rem else 0)
    return first, last


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``"cuda"`` without an index means
    ``cuda:{LOCAL_RANK}`` (``torchrun`` sets it; 0 without it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None, device="cuda") -> None:
    """Initialise the process group (the ``mpirun -n P`` analogue).

    * With explicit arguments (``coordinator_address`` as ``host:port`` or
      a ``tcp://`` / ``file://`` URL, ``num_processes``, ``process_id``) it
      initialises a group there, and fails loudly if that does not work.
    * Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment)
      it reads ``env://``.
    * With neither it stays one process, as the JAX package's auto-detect
      does when it finds no cluster.

    The backend is NCCL when the rank's ``device`` is CUDA and gloo on the
    CPU; ``backend`` overrides it (gloo reduces CUDA tensors too, the way
    two ranks share one card).  A group that exists already is kept."""
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dist.is_initialized() or not (explicit or torchrun):
        return
    device = local_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "init_multihost needs coordinator_address, num_processes "
                "and process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        try:
            dist.init_process_group(backend, init_method=url,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"multi-process initialisation at {url} failed (rank "
                f"{process_id} of {num_processes}, {backend}): {e}") from e
        return
    dist.init_process_group(backend, init_method="env://")


def replication_error(tree, group) -> torch.Tensor:
    """Max absolute divergence of a dict (or sequence) of tensors across the
    ranks of ``group``: the reference relies on SPMD determinism for
    parameter replication (SURVEY.md §5.2), and this measures it.  Every
    rank of an all-reduce here ends with the same bits, so replicated
    parameters give exactly 0."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    n = dist.get_world_size(group)
    errs = []
    for x in leaves:
        x = x.detach().float()
        mean = maybe_psum(x.clone(), group) / n
        errs.append((x - mean).abs().max())
    if not errs:
        return torch.zeros(())
    return torch.stack(errs).max()


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


def check_runtime(runtime):
    """``runtime`` if it is a ``MeshRuntime``, else TypeError."""
    if not isinstance(runtime, MeshRuntime):
        raise TypeError("runtime must be a prosper_tpu_torch MeshRuntime, "
                        f"got {type(runtime).__name__}")
    return runtime


class MeshRuntime:
    """The ranks of a process group as a data-parallel mesh, optionally with
    a second, ``state`` axis.

    Parameters
    ----------
    group : the process group (default: the whole world, which
        ``init_multihost`` or ``torchrun`` set up).
    device : this rank's device (default ``cuda:{LOCAL_RANK}``); the CPU
        only when asked.  An NCCL group needs a CUDA device.
    mesh_shape, axis_names : as the JAX package's.  ``(n,)`` /
        ``("data",)``: every rank a data shard.  ``(n_data, n_state)`` /
        ``("data", "state")``: rank r of the group is ``(data_index,
        state_index) = divmod(r, n_state)``, row-major as
        ``np.array(devices).reshape(mesh_shape)`` in the JAX runtime; the
        product must be the group's size.

    ``group`` is the whole mesh: the parameters are replicated over it
    (``replicate``) and ``rank`` is this rank in it, so that rank 0 alone
    writes logs and checkpoints.  ``data_group`` (this rank's column) sums
    the steps' statistics, masks and counts over the data shards;
    ``state_group`` (this rank's row; None without a state axis of more
    than one shard) combines the softmaxes over the state slices.  Every
    rank creates, in the same order, one group for each column and one for
    each row (a state axis needs ``group`` to be the whole world).  The
    host collectives (``all_gather_host``, ``gather_host``, ``n_locals``,
    ``stride_order``, ``allreduce_host``) run over the gloo twin of the
    data group; ``broadcast_host`` and ``host_group`` span the mesh.
    Without a state axis (or with one of one shard) ``data_group`` is
    ``group`` and the runtime is the data-only one.
    """

    def __init__(self, group=None, device=None,
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 axis_names: Tuple[str, ...] = ("data",)):
        if not dist.is_initialized():
            raise RuntimeError(
                "MeshRuntime needs an initialised process group: start the "
                "ranks with torchrun, or call init_multihost(...) first")
        self.group = dist.group.WORLD if group is None else group
        n = dist.get_world_size(self.group)
        self.axis_names = tuple(axis_names)
        if mesh_shape is None:
            mesh_shape = (n,) + (1,) * (len(self.axis_names) - 1)
        mesh_shape = tuple(int(s) for s in mesh_shape)
        if len(mesh_shape) != len(self.axis_names):
            raise ValueError(f"mesh_shape {mesh_shape} does not match "
                             f"axis_names {self.axis_names}")
        for i, (name, size) in enumerate(zip(self.axis_names[1:],
                                             mesh_shape[1:])):
            if size != 1 and not (i == 0 and name == "state"):
                raise ValueError(
                    f"a {name!r} axis of {size} shards: the mesh takes a "
                    "data axis and, second, a 'state' axis")
        n_state = mesh_shape[1] if len(mesh_shape) > 1 else 1
        if mesh_shape[0] * n_state != n:
            raise ValueError(
                f"the mesh {mesh_shape} has {mesh_shape[0] * n_state} "
                f"shards but the process group has {n} ranks")
        self.mesh_shape = mesh_shape
        self.data_axis = self.axis_names[0]
        self.n_state_shards = n_state
        self.rank = dist.get_rank(self.group)
        self.data_index, self.state_index = divmod(self.rank, n_state)
        self.backend = str(dist.get_backend(self.group))
        self.device = local_device("cuda" if device is None else device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group reduces CUDA tensors; this "
                             f"rank's device is {self.device}")
        self.host_group = self._host_twin(self.group)
        self.data_group, self.state_group = self.group, None
        self.data_host_group = self.host_group
        if n_state > 1:
            if dist.get_world_size() != n:
                raise ValueError("a state axis needs the runtime over the "
                                 "whole world (group=None)")
            self._grid_groups()

    def _host_twin(self, group):
        """``group`` where it is gloo, else a gloo group of its ranks."""
        if str(dist.get_backend(group)) == "gloo":
            return group
        return dist.new_group(dist.get_process_group_ranks(group),
                              backend="gloo")

    def _grid_groups(self) -> None:
        """Set this rank's column (``data_group`` and its gloo twin) and
        row (``state_group``).  Every rank creates every column's group
        with its twin, then every row's, in one order, as
        ``dist.new_group`` requires; no host collective runs over a row,
        so a row has no twin."""
        cols, rows = grid_groups(self.mesh_shape)
        gloo = self.backend == "gloo"
        for ranks in cols:
            g = dist.new_group(ranks)
            twin = g if gloo else dist.new_group(ranks, backend="gloo")
            if self.rank in ranks:
                self.data_group, self.data_host_group = g, twin
        for ranks in rows:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self.state_group = g

    @property
    def n_data_shards(self) -> int:
        return self.mesh_shape[0]

    # -- placement ------------------------------------------------------------

    def _to(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def shard_data(self, tree: Dict) -> Dict[str, torch.Tensor]:
        """This rank's rows (each rank passes those of its data index, e.g.
        its ``stride_data(N, n_data_shards, data_index)`` slice) on this
        rank's device."""
        return {k: self._to(v) for k, v in tree.items()}

    def replicate(self, tree: Dict) -> Dict[str, torch.Tensor]:
        """The tensors on this rank's device, broadcast from rank 0 over
        the whole mesh so that every rank holds rank 0's bits."""
        out = {k: self._to(v).contiguous() for k, v in tree.items()}
        for v in out.values():
            dist.broadcast(v, src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return out

    # -- the wrapped step and decode -------------------------------------------

    def state_kwargs(self, fn) -> Dict:
        """The state axis's keywords for ``fn`` (``state_axis``: the state
        group, ``n_state_shards``) where the mesh has a state axis of more
        than one shard and ``fn``'s signature takes them, else none: a
        model without them (the mixtures) runs state-replicated."""
        if self.state_group is None:
            return {}
        params = inspect.signature(fn).parameters
        if "state_axis" not in params or "n_state_shards" not in params:
            return {}
        return {"state_axis": self.state_group,
                "n_state_shards": self.n_state_shards}

    def shard_step(self, step_fn):
        """``step_fn(params, data, sched, generator)`` with the data group
        bound as ``group``, where the JAX package binds ``axis_name``, and
        the state group as ``state_axis`` with ``n_state_shards`` where the
        step takes them (``state_kwargs``)."""
        return functools.partial(step_fn, group=self.data_group,
                                 **self.state_kwargs(step_fn))

    def shard_decode(self, infer_fn):
        """Data-parallel serving: ``infer_fn(y, params)`` on this rank's rows
        (``y``: those of its data index, host or device) and the
        parameters, both on this rank's device.  The decode is independent
        per row and replicated over the state axis, so the outputs are this
        rank's rows; concatenated over the data axis they are the
        one-process decode of the concatenated rows (the JAX runtime
        returns the global array instead)."""
        def decode(y, params):
            return infer_fn(rows_to_device(y, self.device),
                            {k: self._to(v) for k, v in params.items()})
        return decode

    # -- host collectives (gloo, CPU tensors) over the data axis ---------------

    def all_gather_host(self, a: np.ndarray) -> List[np.ndarray]:
        """Every data shard's ``a`` (one shape and dtype on all), in data
        order."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(self.n_data_shards)]
        dist.all_gather(parts, t, group=self.data_host_group)
        return [p.numpy() for p in parts]

    def gather_host(self, a: np.ndarray) -> Optional[List[np.ndarray]]:
        """Every data shard's ``a`` (one shape and dtype on all), in data
        order, on the rank of data index 0 of this column (on rank 0 where
        there is no state axis); None on the others."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = ([torch.empty_like(t) for _ in range(self.n_data_shards)]
                 if self.data_index == 0 else None)
        dist.gather(t, parts,
                    dst=dist.get_global_rank(self.data_host_group, 0),
                    group=self.data_host_group)
        return None if parts is None else [p.numpy() for p in parts]

    def allreduce_host(self, x, op: str) -> np.ndarray:
        """``x`` reduced over the data shards ("sum", "min" or "max"), in
        data order on every rank, so that every rank gets the same bits
        (``host_quantile_threshold``'s ``allreduce``)."""
        x = np.asarray(x)
        parts = np.stack(self.all_gather_host(x))
        return {"sum": parts.sum, "min": parts.min,
                "max": parts.max}[op](axis=0).astype(x.dtype).reshape(x.shape)

    def broadcast_host(self, a: np.ndarray) -> np.ndarray:
        """Rank 0's ``a`` on every rank of the mesh (the same shape and
        dtype on all)."""
        t = torch.from_numpy(np.array(a, copy=True))
        dist.broadcast(t, src=dist.get_global_rank(self.host_group, 0),
                       group=self.host_group)
        return t.numpy()

    def n_locals(self, n: int) -> np.ndarray:
        """Every data shard's count ``n`` (e.g. of rows), in data order."""
        return np.concatenate(self.all_gather_host(
            np.asarray([n], np.int64)))

    def stride_order(self, a: torch.Tensor, counts) -> np.ndarray:
        """The first ``counts[d]`` rows of every data shard's ``a`` (one
        shape on all, e.g. padded to the longest shard), in data order: the
        global array in ``stride_data`` order, on the host of every rank."""
        parts = self.all_gather_host(a.cpu().numpy())
        return np.concatenate([p[:n] for p, n in zip(parts, counts)])
