"""State sharding in the port: the ``("data", "state")`` mesh of
``MeshRuntime`` and every E-step that honours its state axis, on the CPU.

The port's counterpart of tests/test_state_sharding.py.  Two parts:

* In one process, without gloo (``tests/state_threads.py``: n threads, one
  per state rank, with an in-process all-reduce): the sharded chunk
  E-steps (``_chunk_estats`` sliced, ``_chunk_estats_bigs`` with s_block
  16 and 32 and through the kernel's plain version, the max family's loop
  form, GSC's level-aligned layout) over n = 2, 3, 4 shards against the
  port's unsharded E-step (F and the summed sums within rtol 2e-6 /
  atol 1e-6 of each sum's largest entry: the same terms added in another
  grouping, a few float32 roundings apart; 2e-7 fails for TSC) and the JAX
  package's unsharded function on the same numpy inputs (rtol 1e-4, the
  tolerance of the other E-step parities); F the same bits on every state
  rank; two all-reduces per chunk of rows; and the max
  family's loop form without a state axis against the JAX package's
  ``dp_winner=False``.
* Four gloo processes (the file is its own worker, started once: ``python
  tests/test_torch_state_sharding.py RANK 4 PORT DIR``) run every case
  through ``EM.run`` on the grids (2, 2), (1, 4) and (4, 1) in turn: BSC
  and TSC (the kernel's plain version on each slice), S = 50 over 4 shards
  (``backend="plain"``, ``_chunk_estats`` sliced), ``s_block`` 16 and 32
  (the latter with slices of padding alone), big-S TSC at H'=10, gamma=5,
  S = 12564, DSC with a learned value set, MCA and MMCA (the loop form),
  GSC, MoG (state-replicated), ``StreamingEM`` and a decode.  Meanwhile the
  pytest process runs the JAX package's ``EM`` on the same grids of the
  conftest's virtual CPU devices; the workers import no JAX.  Against JAX:
  test_state_sharding.py's tolerances (rtol/atol 2e-3; Q_mean rtol 1e-3 at
  S = 12564).  Against the port's one-process run: the parameters within
  rtol 1e-4 / atol 1e-5 and Q_mean within rtol 1e-6 (the only difference
  is the order of float32 sums across the state slices and data shards;
  a few iterations of the closed-form M-step carry it to 2e-5 in W at
  these sizes, so 1e-5 / 1e-6 fails).  Exact: the parameters the same
  bits on every rank
  (replication error 0 over the world), F the same bits on the state ranks
  of a row, a state axis of one shard bit for bit the data-only runtime,
  ``run_scanned`` bit for bit ``run``, ``StreamingEM`` bit for bit the
  in-memory run cut as its segments, and the decode, concatenated over the
  data axis, bit for bit the one-process decode.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
GRIDS = ((2, 2), (1, 4), (4, 1))
JAX_GRIDS = ((2, 2), (1, 4))
P = 4
# test_state_sharding.py's tolerances against the JAX package
JAX_RTOL = JAX_ATOL = 2e-3
BIGS_Q_RTOL = 1e-3
# against the port's one-process run (module docstring)
ONE_W_RTOL, ONE_W_ATOL, ONE_Q_RTOL = 1e-4, 1e-5, 1e-6

#: name -> (model class, its arguments, its keywords, ground truth, N, data
#: seed, iterations, EM seed): tests/test_state_sharding.py's cases
CASES = {
    "bsc": ("BSC", (16, 8, 6, 4), {"chunk": 256}, "bars1", 256, 2, 4, 7),
    "tsc": ("TSC", (16, 8, 6, 4), {"chunk": 256}, "bars1", 256, 3, 4, 7),
    "s50": ("BSC", (16, 8, 6, 4), {"chunk": 128, "backend": "plain"},
            "bars1", 128, 5, 3, 1),
    "sblock16": ("BSC", (16, 8, 6, 4),
                 {"chunk": 128, "s_block": 16, "backend": "plain"},
                 "bars1", 128, 13, 3, 1),
    "sblock32": ("BSC", (16, 8, 6, 4),
                 {"chunk": 128, "s_block": 32, "backend": "plain"},
                 "bars1", 128, 13, 3, 1),
    "bigs": ("TSC", (36, 12, 10, 5), {"chunk": 32}, "bars2", 64, 9, 2, 3),
    "dsc_phi": ("DSC", (16, 8, 5, 3),
                {"phi": (-1.0, 1.0, 2.0),
                 "to_learn": ("W", "pi", "sigma", "phi"), "chunk": 64},
                "dsc", 128, 32, 3, 1),
    "mca": ("MCA", (16, 8, 5, 3), {"chunk": 64}, "bars1", 128, 11, 3, 1),
    "mmca": ("MMCA", (16, 8, 5, 3), {"chunk": 64}, "bars1", 128, 12, 3, 1),
    "gsc": ("GSC", (16, 12, 5, 3), {"chunk": 64}, "gsc", 128, 22, 3, 1),
    "mog": ("MoG", (), {"D": 8, "K": 4}, "mog", 128, 4, 3, 1),
}
#: the streamed case (BSC in segments of 64 rows; the plain version, whose
#: E-step cuts the rows into chunks of 64 as the segments, where the
#: kernel's takes them in chunks of at least 1024), and the decoded model
STREAM = ("BSC", (16, 8, 6, 4), {"chunk": 64, "backend": "plain"})
STREAM_SEG = 64
DECODE = ("BSC", (16, 8, 6, 4), {})


def _gt(kind, model):
    """Ground truth numpy parameters, as tests/test_state_sharding.py
    makes them."""
    from prosper_tpu_torch.data.bars import bars_gt_params
    if kind == "bars1":
        return bars_gt_params(model, intensity=10.0, sigma=1.0)
    if kind == "bars2":
        return bars_gt_params(model, intensity=10.0, sigma=2.0)
    if kind == "dsc":
        return {"W": np.random.default_rng(31).standard_normal(
            (16, 8)).astype(np.float32) * 2.0,
            "pi": np.full((3,), 0.05, np.float32), "sigma": np.float32(0.5)}
    if kind == "gsc":
        rng = np.random.default_rng(21)
        return {"W": rng.standard_normal((16, 12)).astype(np.float32) * 2.0,
                "pi": np.float32(0.15), "sigma": np.float32(0.5),
                "mu": np.float32(1.0), "psi": np.float32(0.5)}
    rng = np.random.default_rng(4)
    return {"mu": rng.standard_normal((4, 8)).astype(np.float32) * 4.0,
            "pi": np.full((4,), 0.25, np.float32),
            "sigma": np.full((4,), 0.5, np.float32)}


def _torch_model(spec):
    from prosper_tpu_torch.models import (BSC, DSC, GSC, MCA, MMCA, TSC,
                                          mixtures)
    cls, args, kw = spec[:3]
    ctor = dict(BSC=BSC, TSC=TSC, DSC=DSC, MCA=MCA, MMCA=MMCA, GSC=GSC,
                MoG=mixtures.MoG)[cls]
    return ctor(*args, **kw)


def _write_inputs(wd: Path) -> None:
    """Each case's rows (the port's generator, the JAX package's numbers)
    and held-out rows with parameters for the decode."""
    for name, spec in CASES.items():
        model = _torch_model(spec)
        np.save(wd / f"{name}.npy", model.generate_data(
            _gt(spec[3], model), spec[4], seed=spec[5])["y"])
    rng = np.random.default_rng(0)
    np.save(wd / "held_out.npy",
            (rng.standard_normal((101, 16)) * 2.0).astype(np.float32))
    np.savez(wd / "decode_params.npz",
             W=rng.standard_normal((16, 8)).astype(np.float32),
             pi=np.float32(0.2), sigma=np.float32(1.5))


# ---------------------------------------------------------------------------
# the worker (one process per rank)
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, port: int, wd: Path) -> None:
    """Every case on every grid on this rank; results in ``rank{r}.npz``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    from prosper_tpu_torch import EM, LinearAnnealing, StreamingEM
    from prosper_tpu_torch.parallel.mesh import (MeshRuntime, init_multihost,
                                                 replication_error,
                                                 stride_data)
    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {}

    def mine(a, rt):
        first, last = stride_data(a.shape[0], rt.n_data_shards,
                                  rt.data_index)
        return np.ascontiguousarray(a[first:last])

    def keep(tag, run, rt):
        for k, v in run.params.items():
            out[f"{tag}.p.{k}"] = v.numpy()
        out[f"{tag}.reperr"] = float(replication_error(run.params, rt.group))
        out[f"{tag}.Q_mean"] = np.asarray([h["Q_mean"] for h in run.history])
        F = run.data["F_prev"] if isinstance(run, EM) else run.F_prev
        out[f"{tag}.F"] = F.numpy()

    def em(spec, y, rt, **kw):
        run = EM(_torch_model(spec), LinearAnnealing(spec[6]),
                 {"y": mine(y, rt)}, seed=spec[7], runtime=rt, device="cpu",
                 **kw)
        run.run()
        return run

    held = np.load(wd / "held_out.npy")
    p_dec = {k: torch.as_tensor(v)
             for k, v in np.load(wd / "decode_params.npz").items()}
    for grid in GRIDS:
        g = f"{grid[0]}x{grid[1]}"
        rt = MeshRuntime(device="cpu", mesh_shape=grid,
                         axis_names=("data", "state"))
        out[f"{g}.coords"] = np.asarray([rt.data_index, rt.state_index])
        for name, spec in CASES.items():
            keep(f"{g}.{name}", em(spec, np.load(wd / f"{name}.npy"), rt),
                 rt)
        # run_scanned (the plain loop on the CPU) against run
        spec = CASES["bsc"]
        run = EM(_torch_model(spec), LinearAnnealing(spec[6]),
                 {"y": mine(np.load(wd / "bsc.npy"), rt)}, seed=spec[7],
                 runtime=rt, device="cpu")
        run.run_scanned()
        keep(f"{g}.bsc_scanned", run, rt)
        # streamed in segments of 64 rows against the in-memory run whose
        # E-step is cut as the segments, both from the one-process init of
        # all rows (a streamed run's own init reads its first segment)
        y = np.load(wd / "bsc.npy")
        sspec = STREAM + spec[3:]
        p0 = _torch_model(sspec).standard_init({"y": y}, device="cpu")
        sem = StreamingEM(_torch_model(sspec),
                          LinearAnnealing(spec[6]), mine(y, rt),
                          seg_size=STREAM_SEG, params=p0, seed=spec[7],
                          runtime=rt, device="cpu")
        sem.run()
        keep(f"{g}.stream", sem, rt)
        keep(f"{g}.stream_mem", em(sspec, y, rt, params=p0), rt)
        # the decode of this rank's held-out rows
        dec = _torch_model(DECODE).inference(p_dec, {"y": mine(held, rt)},
                                             top_L=4, runtime=rt)
        for k, v in dec.items():
            out[f"{g}.decode.{k}"] = v.numpy()
    # the data-only runtime: the (4, 1) grid's runs, bit for bit
    rt = MeshRuntime(device="cpu")
    for name in ("bsc", "mca", "gsc"):
        keep(f"data_only.{name}",
             em(CASES[name], np.load(wd / f"{name}.npy"), rt), rt)
    np.savez(wd / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the fixtures: the workers, the JAX package's runs, the port's P=1 runs
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_runs(wd: Path):
    """The JAX package's EM of every case on each grid of JAX_GRIDS (the
    conftest's virtual CPU devices) and of the decode on one device."""
    import jax

    from prosper_tpu.engine.anneal import LinearAnnealing as JLA
    from prosper_tpu.engine.em import EM as JEM
    from prosper_tpu.models import gsc as jgsc
    from prosper_tpu.models import linear as jlinear
    from prosper_tpu.models import mca as jmca
    from prosper_tpu.models import mixtures as jmix
    from prosper_tpu.parallel.mesh import MeshRuntime as JMesh

    ctors = dict(BSC=jlinear.BSC, TSC=jlinear.TSC, DSC=jlinear.DSC,
                 MCA=jmca.MCA, MMCA=jmca.MMCA, GSC=jgsc.GSC, MoG=jmix.MoG)
    out = {}
    for grid in JAX_GRIDS:
        rt = JMesh(devices=jax.devices()[:4], mesh_shape=grid,
                   axis_names=("data", "state"))
        for name, spec in CASES.items():
            cls, args, kw = spec[:3]
            kw = {k: v for k, v in kw.items() if k != "backend"}
            em = JEM(ctors[cls](*args, **kw), JLA(spec[6]),
                     {"y": np.load(wd / f"{name}.npy")}, seed=spec[7],
                     runtime=rt)
            p = em.run()
            out[(grid, name)] = ({k: np.asarray(v) for k, v in p.items()},
                                 np.asarray([h["Q_mean"]
                                             for h in em.history]))
    params = dict(np.load(wd / "decode_params.npz"))
    dec = jlinear.BSC(*DECODE[1], **DECODE[2]).inference(
        params, {"y": np.load(wd / "held_out.npy")}, top_L=4)
    out["decode"] = {k: np.asarray(v) for k, v in dec.items()}
    return out


def _one_process(wd: Path):
    """The port's runs without a runtime: every case, the streamed model
    and the decode."""
    import torch

    from prosper_tpu_torch import EM, LinearAnnealing
    out = {}
    for name, spec in CASES.items():
        em = EM(_torch_model(spec), LinearAnnealing(spec[6]),
                {"y": np.load(wd / f"{name}.npy")}, seed=spec[7],
                device="cpu")
        p = em.run()
        out[name] = ({k: v.numpy() for k, v in p.items()},
                     np.asarray([h["Q_mean"] for h in em.history]))
    params = {k: torch.as_tensor(v)
              for k, v in np.load(wd / "decode_params.npz").items()}
    dec = _torch_model(DECODE).inference(
        params, {"y": np.load(wd / "held_out.npy")}, top_L=4)
    out["decode"] = {k: v.numpy() for k, v in dec.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the JAX runs, the port's P=1 runs): the four
    workers run while the pytest process computes the references."""
    wd = tmp_path_factory.mktemp("state")
    _write_inputs(wd)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(P),
                               str(port), str(wd)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(P)]
    try:
        jax_out = _jax_runs(wd)
        one = _one_process(wd)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    res = [dict(np.load(wd / f"rank{r}.npz")) for r in range(P)]
    return res, jax_out, one


def _grid(g):
    return f"{g[0]}x{g[1]}"


def _params(res, tag):
    """Rank 0's parameters of ``tag``, after checking that every rank holds
    the same bits and read a replication error of 0."""
    keys = [k for k in res[0] if k.startswith(f"{tag}.p.")]
    assert keys, tag
    for r in res:
        assert float(r[f"{tag}.reperr"]) == 0.0, tag
        for k in keys:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    return {k.rsplit(".", 1)[1]: res[0][k] for k in keys}


# ---------------------------------------------------------------------------
# the runs across processes
# ---------------------------------------------------------------------------


def test_ranks_lie_on_the_grid_row_major(runs):
    res = runs[0]
    for grid in GRIDS:
        for r, out in enumerate(res):
            assert tuple(out[f"{_grid(grid)}.coords"]) == divmod(r, grid[1])


@pytest.mark.parametrize("grid", JAX_GRIDS, ids=_grid)
@pytest.mark.parametrize("name", list(CASES))
def test_every_case_matches_jax_on_the_same_grid(runs, grid, name):
    res, jax_out, _ = runs
    got = _params(res, f"{_grid(grid)}.{name}")
    want, q_want = jax_out[(grid, name)]
    assert set(got) == set(want), name
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=f"{name} {k}")
    q = res[0][f"{_grid(grid)}.{name}.Q_mean"]
    if name == "bigs":
        np.testing.assert_allclose(q, q_want, rtol=BIGS_Q_RTOL)
    else:
        np.testing.assert_allclose(q, q_want, rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("grid", GRIDS, ids=_grid)
@pytest.mark.parametrize("name", list(CASES))
def test_every_case_matches_the_one_process_run(runs, grid, name):
    res, _, one = runs
    got = _params(res, f"{_grid(grid)}.{name}")
    want, q_want = one[name]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ONE_W_RTOL,
                                   atol=ONE_W_ATOL, err_msg=f"{name} {k}")
    np.testing.assert_allclose(res[0][f"{_grid(grid)}.{name}.Q_mean"],
                               q_want, rtol=ONE_Q_RTOL)


@pytest.mark.parametrize("grid", GRIDS, ids=_grid)
def test_F_is_the_same_bits_on_the_state_ranks_of_a_row(runs, grid):
    res = runs[0]
    n_state = grid[1]
    for name in CASES:
        tag = f"{_grid(grid)}.{name}.F"
        for r in range(P):
            row0 = (r // n_state) * n_state
            np.testing.assert_array_equal(res[r][tag], res[row0][tag],
                                          err_msg=f"{name} rank {r}")


def test_a_state_axis_of_one_shard_is_the_data_only_runtime(runs):
    res = runs[0]
    for name in ("bsc", "mca", "gsc"):
        a = _params(res, f"4x1.{name}")
        b = _params(res, f"data_only.{name}")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        for r in res:
            np.testing.assert_array_equal(r[f"4x1.{name}.F"],
                                          r[f"data_only.{name}.F"])
            np.testing.assert_array_equal(r[f"4x1.{name}.Q_mean"],
                                          r[f"data_only.{name}.Q_mean"])


@pytest.mark.parametrize("grid", GRIDS, ids=_grid)
def test_run_scanned_equals_run(runs, grid):
    res = runs[0]
    a = _params(res, f"{_grid(grid)}.bsc")
    b = _params(res, f"{_grid(grid)}.bsc_scanned")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r in res:
        np.testing.assert_array_equal(r[f"{_grid(grid)}.bsc.F"],
                                      r[f"{_grid(grid)}.bsc_scanned.F"])


@pytest.mark.parametrize("grid", GRIDS, ids=_grid)
def test_streaming_on_the_grid(runs, grid):
    """StreamingEM equals the in-memory EM cut as its segments, bit for
    bit, and the JAX package's EM of the case within its tolerance."""
    res, jax_out, _ = runs
    g = _grid(grid)
    got = _params(res, f"{g}.stream")
    mem = _params(res, f"{g}.stream_mem")
    for k in got:
        np.testing.assert_array_equal(got[k], mem[k], err_msg=k)
    want = jax_out[(grid if grid in JAX_GRIDS else (2, 2), "bsc")][0]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=_grid)
def test_decode_concatenated_over_the_data_axis(runs, grid):
    """Each row decodes its data shard, replicated over the state axis; the
    data shards concatenated are the one-process decode, bit for bit, and
    the JAX package's within its tolerance."""
    res, jax_out, one = runs
    n_state = grid[1]
    for k, want in one["decode"].items():
        tag = f"{_grid(grid)}.decode.{k}"
        for r in range(P):
            np.testing.assert_array_equal(
                res[r][tag], res[(r // n_state) * n_state][tag], err_msg=k)
        got = np.concatenate([res[d * n_state][tag]
                              for d in range(grid[0])])
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("F", "s_mean"):
        np.testing.assert_allclose(one["decode"][k], jax_out["decode"][k],
                                   rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the combine algebra in one process (tests/state_threads.py)
# ---------------------------------------------------------------------------

SHARD_RTOL, SHARD_ATOL = 2e-6, 1e-6
JAX_E_RTOL = 1e-4


def _linear_inputs(values, N=64, D=16, H=8, Hp=6, gamma=4, seed=0):
    from prosper_tpu_torch.core.states import discrete_state_space
    rng = np.random.default_rng(seed)
    K = len(values)
    return dict(
        y=(rng.standard_normal((N, D)) * 2).astype(np.float32),
        w=(rng.random(N) > 0.2).astype(np.float32),
        W=rng.standard_normal((D, H)).astype(np.float32),
        lo=np.full((K,), np.log(2.0 / (H * K)) - np.log1p(-2.0 / H),
                   np.float32),
        Hp=Hp, space=discrete_state_space(Hp, gamma, values),
        signed=len(values) > 1)


def _shard_close(sharded, ref):
    """(F, sums) of every state rank against the unsharded (F, sums): F the
    same bits on every rank and close to the reference, the sums added
    over the ranks close to the reference's."""
    import torch
    (F0, _), parts = sharded[0], sharded
    for F, _ in parts[1:]:
        assert torch.equal(F, F0)
    torch.testing.assert_close(F0, ref[0], rtol=SHARD_RTOL, atol=SHARD_ATOL)
    for k, v in ref[1].items():
        got = sum(s[k] for _, s in parts)
        torch.testing.assert_close(got, v, rtol=SHARD_RTOL,
                                   atol=SHARD_ATOL * max(
                                       float(v.abs().max()), 1.0), msg=k)


def _jax_close(ref, F_j, s_j):
    np.testing.assert_allclose(ref[0].numpy(), np.asarray(F_j),
                               rtol=JAX_E_RTOL, atol=1e-4)
    for k, v in ref[1].items():
        scale = max(float(np.abs(np.asarray(s_j[k])).max()), 1.0)
        np.testing.assert_allclose(v.numpy(), np.asarray(s_j[k]),
                                   rtol=JAX_E_RTOL, atol=JAX_E_RTOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("values", [(1.0,), (-1.0, 1.0)], ids=["bsc", "tsc"])
@pytest.mark.parametrize("path", ["rows", "sblock16", "sblock32", "kernel"])
def test_linear_shards_combine_to_the_unsharded_estep(n, values, path):
    """``_chunk_estats`` sliced (rows), ``_chunk_estats_bigs`` at s_block 16
    and 32 (the latter with shards of padding alone at S = 50, n = 4), and
    the big-S kernel's plain version on ``ceil(S / n)``-state slices."""
    import jax.numpy as jnp
    import torch

    from prosper_tpu.core.etstep import linear_et_estep as jax_estep
    from prosper_tpu.core.etstep import state_arrays_from as jax_sa
    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.ops import linear_cuda
    from state_threads import run_state_shards

    a = _linear_inputs(values)
    sa = etstep.state_arrays_from(a["space"], "cpu")
    s_block = {"rows": 0, "sblock16": 16, "sblock32": 32, "kernel": 0}[path]
    args = (torch.tensor(a["y"]), torch.tensor(a["w"]), torch.tensor(a["W"]),
            torch.tensor(2.0), torch.tensor(a["lo"]), sa, a["Hp"],
            a["signed"], 0.7, 0.9)
    ref = etstep.linear_et_estep(*args, chunk=32, s_block=s_block)
    fn = linear_cuda.linear_et_estep if path == "kernel" else \
        etstep.linear_et_estep
    parts, calls = run_state_shards(n, lambda g: fn(
        *args, chunk=32, s_block=s_block, state_axis=g, n_state_shards=n))
    _shard_close(parts, ref)
    # two all-reduces per chunk of rows: the MAX of both channels' row
    # maxima, the SUM of both channels' masses (the kernel's path takes
    # all 64 rows in one chunk, the plain version chunks of 32)
    assert calls == [2 * (1 if path == "kernel" else 2)] * n
    F_j, s_j = jax_estep(jnp.asarray(a["y"]), jnp.asarray(a["w"]),
                         jnp.asarray(a["W"]), jnp.float32(2.0),
                         jnp.asarray(a["lo"]), jax_sa(a["space"]), a["Hp"],
                         a["signed"], jnp.float32(0.7), jnp.float32(0.9),
                         chunk=32, s_block=s_block)
    _jax_close(ref, F_j, s_j)


def test_padding_slices_add_nothing():
    """S = 50 over 4 shards at s_block = 32: shards 2 and 3 hold padding
    alone; their ``bigs_multi`` is m = NEG, l = 0, zero moments, their
    share of the sums is exactly 0, and the kernel's wrapper gives the same
    for a table of no state without a launch."""
    import torch

    from prosper_tpu_torch.core import etstep
    from prosper_tpu_torch.ops import bigs_cuda, cuda_lib
    from state_threads import run_state_shards

    a = _linear_inputs((1.0,))
    sa = etstep.state_arrays_from(a["space"], "cpu")
    assert sa.states.shape[0] == 50
    y, w, W = (torch.tensor(a[k]) for k in ("y", "w", "W"))
    gram = W.T @ W
    for srank in range(4):
        _, _, tables = etstep.bigs_front(y, W, gram, torch.diagonal(gram),
                                         torch.tensor(a["lo"]), sa, 6, False,
                                         32, shard=(srank, 4))
        out = etstep.bigs_multi(*tables, 0.25, 0.7, 0.9, 32)
        assert tables[2].shape[0] == 32
        if srank >= 2:
            assert float(tables[6].sum()) == 0.0
            assert torch.all(out[0] == etstep.NEG)
            assert torch.all(out[2] == etstep.NEG)
            for t in out[1:2] + out[3:]:
                assert torch.all(t == 0.0)
    empty = [t[:0] if i >= 2 else t for i, t in enumerate(tables)]
    before = dict(cuda_lib.LAUNCHES)
    got = bigs_cuda.bigs_multi_cuda(*empty, 0.25, 0.7, 0.9, 32) \
        if torch.cuda.is_available() else bigs_cuda.empty_moments(
            64, 6, 1, "cpu")
    want = etstep.bigs_multi(*empty, 0.25, 0.7, 0.9, 32)
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)
    assert cuda_lib.LAUNCHES == before
    parts, _ = run_state_shards(4, lambda g: etstep.linear_et_estep(
        y, w, W, torch.tensor(2.0), torch.tensor(a["lo"]), sa, 6, False,
        0.7, 0.9, chunk=64, s_block=32, state_axis=g, n_state_shards=4))
    for _, sums in parts[2:]:
        for k, v in sums.items():
            assert torch.all(v == 0.0), k


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
@pytest.mark.parametrize("rho", [None, 2.0], ids=["hard", "soft"])
def test_max_shards_combine_to_the_unsharded_estep(n, magnitude, rho):
    """The loop form on each slice against the port's unsharded E-step (the
    subset-lattice DP: the same winners, the responsibilities summed in
    another order) and the JAX package's ``dp_winner=False``."""
    import jax.numpy as jnp
    import torch

    from prosper_tpu.core.etstep import state_arrays_from as jax_sa
    from prosper_tpu.core.maxstep import max_et_estep as jax_estep
    from prosper_tpu.core.states import binary_state_space as jax_space
    from prosper_tpu_torch.core import etstep, maxstep
    from prosper_tpu_torch.core.states import binary_state_space
    from state_threads import run_state_shards

    rng = np.random.default_rng(3)
    y = (rng.standard_normal((64, 16)) * 2).astype(np.float32)
    W = rng.standard_normal((16, 8)).astype(np.float32)
    if not magnitude:
        W = np.abs(W)
    w = (rng.random(64) > 0.2).astype(np.float32)
    sa = etstep.state_arrays_from(binary_state_space(5, 3), "cpu")
    args = (torch.tensor(y), torch.tensor(w), torch.tensor(W),
            torch.tensor(1.3), torch.tensor(-1.5), sa, 5, magnitude, 0.8, 1.0)
    ref = maxstep.max_et_estep(*args, chunk=32, rho=rho)
    loop = maxstep.max_et_estep(*args, chunk=32, rho=rho, dp_winner=False)
    assert torch.equal(loop[0], ref[0])
    parts, calls = run_state_shards(n, lambda g: maxstep.max_et_estep(
        *args, chunk=32, rho=rho, state_axis=g, n_state_shards=n))
    _shard_close(parts, ref)
    assert calls == [2 * 2] * n
    F_j, s_j = jax_estep(jnp.asarray(y), jnp.asarray(w), jnp.asarray(W),
                         jnp.float32(1.3), jnp.float32(-1.5),
                         jax_sa(jax_space(5, 3)), 5, magnitude,
                         jnp.float32(0.8), jnp.float32(1.0), chunk=32,
                         rho=jnp.float32(0.0 if rho is None else rho),
                         dp_winner=False)
    _jax_close(loop, F_j, s_j)


@pytest.mark.parametrize("magnitude", [False, True], ids=["mca", "mmca"])
def test_max_route_under_a_state_axis_is_the_loop_form(magnitude):
    """The family's route, ``ops/max_cuda.py::max_et_estep``, under a state
    axis on CPU tensors: the plain loop form on each rank's slice, hard and
    soft, bit for bit ``core.maxstep.max_et_estep`` under the same axis,
    launching nothing."""
    import torch

    from prosper_tpu_torch.core import etstep, maxstep
    from prosper_tpu_torch.core.states import binary_state_space
    from prosper_tpu_torch.ops import cuda_lib, max_cuda
    from state_threads import run_state_shards

    rng = np.random.default_rng(5)
    y = (rng.standard_normal((64, 16)) * 2).astype(np.float32)
    W = rng.standard_normal((16, 8)).astype(np.float32)
    if not magnitude:
        W = np.abs(W)
    w = (rng.random(64) > 0.2).astype(np.float32)
    sa = etstep.state_arrays_from(binary_state_space(5, 3), "cpu")
    args = (torch.tensor(y), torch.tensor(w), torch.tensor(W),
            torch.tensor(1.3), torch.tensor(-1.5), sa, 5, magnitude, 0.8, 1.0)
    before = dict(cuda_lib.LAUNCHES)
    for rho in (None, 2.0):
        def shards(estep):
            return run_state_shards(2, lambda g: estep(
                *args, chunk=32, rho=rho, state_axis=g, n_state_shards=2))[0]
        got, want = shards(max_cuda.max_et_estep), shards(maxstep.max_et_estep)
        for (F, sums), (F0, sums0) in zip(got, want):
            assert torch.equal(F, F0)
            assert set(sums) == set(sums0)
            for k in sums0:
                assert torch.equal(sums[k], sums0[k]), (rho, k)
    assert cuda_lib.LAUNCHES == before


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gsc_shards_combine_to_the_unsharded_estep(n):
    """The level-aligned layout: shard r holds the JAX package's shard r's
    supports; every shard solves its levels at their size."""
    import jax.numpy as jnp
    import torch

    from prosper_tpu.core.etstep import state_arrays_from as jax_sa
    from prosper_tpu.core.gscstep import \
        _gsc_shard_level_arrays as jax_layout
    from prosper_tpu.core.gscstep import gsc_et_estep as jax_estep
    from prosper_tpu.core.states import binary_state_space as jax_space
    from prosper_tpu_torch.core import etstep, gscstep
    from prosper_tpu_torch.core.states import binary_state_space
    from state_threads import run_state_shards

    space = binary_state_space(5, 3)
    act = space.states > 0.5
    _, _, st_j, sv_j, ab_j = jax_layout(act, n)
    st, sv, ab = gscstep._gsc_shard_level_arrays(act, n)
    np.testing.assert_array_equal(st, st_j)
    np.testing.assert_array_equal(sv, sv_j)
    np.testing.assert_array_equal(ab, ab_j)
    rng = np.random.default_rng(21)
    y = (rng.standard_normal((64, 16)) * 1.5).astype(np.float32)
    W = rng.standard_normal((16, 12)).astype(np.float32)
    w = (rng.random(64) > 0.1).astype(np.float32)
    sa = etstep.state_arrays_from(space, "cpu")
    args = (torch.tensor(y), torch.tensor(w), torch.tensor(W),
            torch.tensor(0.5), torch.tensor(0.15), torch.tensor(1.0),
            torch.tensor(0.5), sa, 5, 0.8, 1.0)
    ref = gscstep.gsc_et_estep(*args, chunk=32)
    parts, calls = run_state_shards(n, lambda g: gscstep.gsc_et_estep(
        *args, chunk=32, state_axis=g, n_state_shards=n))
    _shard_close(parts, ref)
    assert calls == [2 * 2] * n
    F_j, s_j = jax_estep(jnp.asarray(y), jnp.asarray(w), jnp.asarray(W),
                         jnp.float32(0.5), jnp.float32(0.15),
                         jnp.float32(1.0), jnp.float32(0.5),
                         jax_sa(jax_space(5, 3)), 5, jnp.float32(0.8),
                         jnp.float32(1.0), chunk=32)
    _jax_close(ref, F_j, s_j)


def test_sums_reduce_over_both_axes_with_N_total_once():
    """``reduce_sums`` under a state axis: the sums added over the state
    ranks, ``N_total`` counted on state rank 0 alone."""
    import torch

    from prosper_tpu_torch.models.linear import reduce_sums
    from state_threads import run_state_shards

    parts, calls = run_state_shards(3, lambda g: reduce_sums(
        {"xs": torch.full((2, 2), float(g.rank + 1))}, torch.tensor(10.0),
        None, g, 3))
    for sums, N in parts:
        assert torch.equal(sums["xs"], torch.full((2, 2), 6.0))
        assert float(N) == 10.0
    assert calls == [1, 1, 1]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]))
