"""The port's data-parallel runtime across real processes, on the CPU.

The port's version of tests/test_multiprocess.py and its worker: P = 2 and
P = 4 processes join one gloo group (the environment ``torchrun`` gives its
ranks), each holds its ``stride_data`` rows, and one launch per P runs every
mode of the worker in turn (this file, run as a script, is the worker), so
that the torch import and the group's set-up are paid once:

* ``train --multihost`` (it initialises the group from the environment)
  against a one-process ``train`` of the same config;
* BSC through ``EM(runtime=)`` on the JAX test's inputs (D=16, H=8,
  N=512, 12 iterations) against the port's one-process run and the JAX
  package's ``EM``, within rtol 2e-4 / atol 2e-5 (the tolerance of
  tests/test_multiprocess.py); rank 0 alone writes the data log and the
  checkpoints; the parameters are replicated exactly;
* ``partial`` < 1 on uneven shards (N = 513): the generators stay equal
  across the ranks;
* ``StreamingEM(runtime=)`` on 513 rows with segments of 128, so that some
  rank's last segment holds padding only: against the one-process streamed
  run, the in-memory run under the same runtime, and a resumed run (equal
  bit for bit);
* revival with resume across ranks (equal bit for bit, revival fired);
* MoG data-parallel against the one-process runs of both packages;
* sharded decode: the ranks' outputs, concatenated, equal the one-process
  decode exactly;
* the Ncut threshold over the ranks' rows (device and host twin) equals the
  one-process threshold over all rows.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
D, H, N, N_ODD = 16, 8, 512, 513
RTOL, ATOL = 2e-4, 2e-5          # tests/test_multiprocess.py:104-105


def _anneal(cls, steps=12, ncut=False, partial=None, noise=None):
    a = cls(steps)
    a["T"] = [(0.0, 1.5), (0.6, 1.0)]
    a["anneal_prior"] = False
    if ncut:
        a["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]
    if partial is not None:
        a["partial"] = partial
    if noise is not None:
        a["W_noise"] = [(0.0, noise), (0.7, 0.0)]
    return a


def _write_inputs(wd: Path):
    """The JAX test's inputs (seed 0), an odd-length set, a held-out set,
    MoG initial parameters, and a CLI config with its data file."""
    from prosper_tpu_torch.data.bars import generate_bars_dict
    from prosper_tpu_torch.data.patches import write_h5_dataset
    from prosper_tpu_torch.models.mixtures import MoG
    rng = np.random.default_rng(0)
    W0 = rng.standard_normal((D, H)).astype(np.float32)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    np.save(wd / "y.npy", y)
    np.savez(wd / "params0.npz", W=W0, pi=np.float32(0.2),
             sigma=np.float32(1.5))
    np.save(wd / "y_odd.npy",
            (rng.standard_normal((N_ODD, D)) * 2.0).astype(np.float32))
    np.save(wd / "held_out.npy",
            (rng.standard_normal((101, D)) * 2.0).astype(np.float32))
    mog = MoG(D, 4).standard_init({"y": y}, seed=1, device="cpu")
    np.savez(wd / "mog0.npz", **{k: v.numpy() for k, v in mog.items()})
    write_h5_dataset(str(wd / "cli.h5"), np.load(wd / "y_odd.npy"))
    cfg = {"model": {"type": "bsc", "D": D, "H": H, "Hprime": 5, "gamma": 3,
                     "chunk": 64},
           "anneal": {"steps": 8, "T": [[0.0, 2.0], [0.7, 1.0]],
                      "Ncut_factor": [[0.4, 0.0], [0.9, 1.0]]},
           "gt_params": {"W": generate_bars_dict(H, intensity=10.0).tolist(),
                         "pi": 0.25, "sigma": 1.0},
           "seed": 3, "checkpoint_every": 3}
    (wd / "cfg.json").write_text(json.dumps(cfg))


# ---------------------------------------------------------------------------
# the worker (one process per rank)
# ---------------------------------------------------------------------------


def _worker(rank: int, P: int, port: int, wd: Path) -> None:
    """Every mode on this rank; its results go to ``rank{rank}.npz``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(P), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    from prosper_tpu_torch import EM, LinearAnnealing, StreamingEM, cli
    from prosper_tpu_torch.core.select import global_quantile_threshold
    from prosper_tpu_torch.engine.stream import host_quantile_threshold
    from prosper_tpu_torch.io.datalog import DataLog, StoreToH5
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.models.mixtures import MoG
    from prosper_tpu_torch.parallel.mesh import (MeshRuntime,
                                                 replication_error,
                                                 stride_data)

    # the command line first: it initialises the group from the environment
    assert cli.main(["train", str(wd / "cfg.json"), "--data",
                     str(wd / "cli.h5"), "-o", str(wd / "cli_p"), "--device",
                     "cpu", "--multihost", "-q"]) == 0
    assert dist.is_initialized() and dist.get_world_size() == P
    rt = MeshRuntime(device="cpu")
    out = {}

    def mine(a):
        first, last = stride_data(a.shape[0])
        return np.ascontiguousarray(a[first:last])

    def keep(tag, params):
        for k, v in params.items():
            out[f"{tag}.{k}"] = v.numpy()
        out[f"reperr.{tag}"] = float(replication_error(params, rt.group))

    y = np.load(wd / "y.npy")
    y_odd = np.load(wd / "y_odd.npy")
    p0 = dict(np.load(wd / "params0.npz"))

    # in memory, rank-0-only files
    log = DataLog()
    log.set_handler(("F_mean", "n_used"), StoreToH5,
                    str(wd / f"log_r{rank}.h5"))
    em = EM(BSC(D, H, 4, 3), _anneal(LinearAnnealing), {"y": mine(y)},
            params=p0, seed=5, runtime=rt, dlog=log,
            checkpoint_path=str(wd / f"ckpt_r{rank}.h5"), checkpoint_every=4)
    em.run()
    log.close()
    keep("basic", em.params)

    # partial < 1 on uneven shards: the generator advances alike
    em = EM(BSC(D, H, 4, 3, chunk=32),
            _anneal(LinearAnnealing, 6, ncut=True, partial=0.6, noise=0.3),
            {"y": mine(y_odd)}, params=p0, seed=7, runtime=rt)
    em.run()
    keep("partial", em.params)
    out["partial_gen"] = em.generator.get_state().numpy()
    out["partial_n_used"] = np.asarray([h["n_used"] for h in em.history])

    # streaming over uneven shards; in memory under the same runtime; resume
    model = BSC(D, H, 4, 3, chunk=32)

    def stream(**kw):
        return StreamingEM(model, _anneal(LinearAnnealing, ncut=True),
                           mine(y_odd), seg_size=128, params=p0, seed=5,
                           runtime=rt, **kw)
    sem = stream()
    out["stream_n_seg"] = sem.n_seg
    out["stream_pad_only"] = int(sem.N <= (sem.n_seg - 1) * sem.seg_size)
    sem.run()
    keep("stream", sem.params)
    em = EM(model, _anneal(LinearAnnealing, ncut=True), {"y": mine(y_odd)},
            params=p0, seed=5, runtime=rt)
    em.run()
    keep("stream_mem", em.params)
    ckpt = str(wd / "stream_ckpt.h5")
    sem = stream(checkpoint_path=ckpt, checkpoint_every=5)
    for _ in range(7):
        sem.step_once()
    sem.close()
    dist.barrier()
    sem = stream()
    assert sem.resume(ckpt) == 5
    sem.run()
    keep("stream_resumed", sem.params)

    # revival and resume across ranks
    kw = dict(params=p0, seed=5, runtime=rt, revive_duplicates=(3, 0.2, 0.9),
              reseed_worst_frac=0.1)
    em = EM(BSC(D, H, 4, 3), _anneal(LinearAnnealing, ncut=True),
            {"y": mine(y)}, **kw)
    em.run()
    keep("revive", em.params)
    out["revive_count"] = em.revival_stats["revived"]
    ckpt = str(wd / "revive_ckpt.h5")
    em = EM(BSC(D, H, 4, 3), _anneal(LinearAnnealing, ncut=True),
            {"y": mine(y)}, checkpoint_path=ckpt, checkpoint_every=5, **kw)
    for _ in range(7):
        em.step_once()
    dist.barrier()
    em = EM(BSC(D, H, 4, 3), _anneal(LinearAnnealing, ncut=True),
            {"y": mine(y)}, **kw)
    assert em.resume(ckpt) == 5
    em.run()
    keep("revive_resumed", em.params)

    # MoG
    em = EM(MoG(D, 4), _anneal(LinearAnnealing, 10), {"y": mine(y)},
            params=dict(np.load(wd / "mog0.npz")), seed=5, runtime=rt)
    em.run()
    keep("mog", em.params)

    # sharded decode of this rank's held-out rows
    dec = BSC(D, H, 4, 3).inference(
        {k: torch.as_tensor(v) for k, v in p0.items()},
        {"y": mine(np.load(wd / "held_out.npy"))}, top_L=4, runtime=rt)
    for k, v in dec.items():
        out[f"decode.{k}"] = v.numpy()

    # the Ncut threshold over every rank's rows
    v = mine(y_odd[:, 0])
    valid = (np.arange(v.shape[0]) % 5 != 0).astype(np.float32)
    keep_n = float(np.ceil(0.4 * rt.allreduce_host(valid.sum(), "sum")))
    out["thresh_dev"] = global_quantile_threshold(
        torch.from_numpy(v), torch.from_numpy(valid),
        torch.tensor(keep_n), group=rt.group).numpy()
    out["thresh_host"] = host_quantile_threshold(
        v, valid, keep_n, allreduce=rt.allreduce_host)

    np.savez(wd / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("inputs")
    _write_inputs(wd)
    return wd


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def ranks(request, inputs, tmp_path_factory):
    """(P, workdir, [each rank's results]) after one launch of P ranks."""
    P = request.param
    wd = tmp_path_factory.mktemp(f"p{P}")
    for f in inputs.iterdir():
        os.symlink(f, wd / f.name)
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
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {P} failed:\n{log}"
    return P, wd, [dict(np.load(wd / f"rank{r}.npz")) for r in range(P)]


@pytest.fixture(scope="module")
def one(inputs):
    """The port's one-process runs (no runtime) of every mode."""
    import torch

    from prosper_tpu_torch import EM, LinearAnnealing, StreamingEM, cli
    from prosper_tpu_torch.models import BSC
    from prosper_tpu_torch.models.mixtures import MoG
    wd = inputs
    y, y_odd = np.load(wd / "y.npy"), np.load(wd / "y_odd.npy")
    p0 = dict(np.load(wd / "params0.npz"))
    out = {}
    em = EM(BSC(D, H, 4, 3), _anneal(LinearAnnealing), {"y": y}, params=p0,
            seed=5, device="cpu")
    out["basic"] = {k: v.numpy() for k, v in em.run().items()}
    sem = StreamingEM(BSC(D, H, 4, 3, chunk=32),
                      _anneal(LinearAnnealing, ncut=True), y_odd,
                      seg_size=128, params=p0, seed=5, device="cpu")
    out["stream"] = {k: v.numpy() for k, v in sem.run().items()}
    em = EM(MoG(D, 4), _anneal(LinearAnnealing, 10), {"y": y},
            params=dict(np.load(wd / "mog0.npz")), seed=5, device="cpu")
    out["mog"] = {k: v.numpy() for k, v in em.run().items()}
    dec = BSC(D, H, 4, 3).inference(
        {k: torch.as_tensor(v) for k, v in p0.items()},
        {"y": np.load(wd / "held_out.npy")}, top_L=4)
    out["decode"] = {k: v.numpy() for k, v in dec.items()}
    assert cli.main(["train", str(wd / "cfg.json"), "--data",
                     str(wd / "cli.h5"), "-o", str(wd / "cli_1"), "--device",
                     "cpu", "-q"]) == 0
    return out


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX package's one-process runs of the in-memory modes."""
    from prosper_tpu.engine.anneal import LinearAnnealing as JLA
    from prosper_tpu.engine.em import EM as JEM
    from prosper_tpu.models.linear import BSC as JBSC
    from prosper_tpu.models.mixtures import MoG as JMoG
    wd = inputs
    y = np.load(wd / "y.npy")
    p0 = dict(np.load(wd / "params0.npz"))

    def data():
        return {"y": y, "valid": np.ones(N, np.float32),
                "F_prev": np.zeros(N, np.float32)}
    out = {}
    em = JEM(JBSC(D, H, Hprime=4, gamma=3), _anneal(JLA), data(),
             params=p0, seed=5)
    out["basic"] = {k: np.asarray(v) for k, v in em.run().items()}
    em = JEM(JMoG(D, 4), _anneal(JLA, 10), data(),
             params=dict(np.load(wd / "mog0.npz")), seed=5)
    out["mog"] = {k: np.asarray(v) for k, v in em.run().items()}
    return out


def _same_on_all(results, tag):
    """The ranks hold the same parameters, bit for bit; rank 0's."""
    keys = [k for k in results[0] if k.split(".")[0] == tag]
    for r in results[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)
    assert all(float(r[f"reperr.{tag}"]) == 0.0 for r in results)
    return {k.split(".", 1)[1]: results[0][k] for k in keys}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def test_in_memory_matches_one_process_and_jax(ranks, one, jax_runs):
    P, _, res = ranks
    got = _same_on_all(res, "basic")
    _close(got, one["basic"], f"P={P} against the port's P=1")
    _close(got, jax_runs["basic"], f"P={P} against the JAX package's EM")


def test_rank0_alone_writes_logs_and_checkpoints(ranks):
    import h5py
    P, wd, _ = ranks
    assert (wd / "log_r0.h5").exists() and (wd / "ckpt_r0.h5").exists()
    for r in range(1, P):
        assert not (wd / f"log_r{r}.h5").exists()
        assert not (wd / f"ckpt_r{r}.h5").exists()
    with h5py.File(wd / "log_r0.h5", "r") as f:
        assert f["F_mean"].shape[0] == 12
        assert set(np.asarray(f["n_used"])) == {float(N)}
    with h5py.File(wd / "ckpt_r0.h5", "r") as f:
        assert f.attrs["step"] == 12
        # the global F_prev: every rank's rows in stride order
        assert f["extra/F_prev"].shape == (N,)


def test_generators_stay_equal_on_uneven_shards(ranks):
    P, _, res = ranks
    for r in res[1:]:
        np.testing.assert_array_equal(r["partial_gen"], res[0]["partial_gen"])
        np.testing.assert_array_equal(r["partial_n_used"],
                                      res[0]["partial_n_used"])
    _same_on_all(res, "partial")
    # partial 0.6 of every rank's rows, then the cut
    assert res[0]["partial_n_used"][0] < 0.61 * N_ODD


def test_streaming_uneven_shards(ranks, one):
    P, _, res = ranks
    assert all(int(r["stream_n_seg"]) == res[0]["stream_n_seg"] for r in res)
    assert any(int(r["stream_pad_only"]) for r in res), \
        "no rank had a segment of padding only"
    got = _same_on_all(res, "stream")
    _close(got, one["stream"], f"streamed P={P} against streamed P=1")
    _close(got, _same_on_all(res, "stream_mem"),
           f"streamed against in-memory EM (P={P})")
    resumed = _same_on_all(res, "stream_resumed")
    for k in got:
        np.testing.assert_array_equal(resumed[k], got[k], err_msg=k)


def test_revival_and_resume_across_ranks(ranks):
    P, _, res = ranks
    assert int(res[0]["revive_count"]) > 0, "revival never fired"
    full = _same_on_all(res, "revive")
    resumed = _same_on_all(res, "revive_resumed")
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


def test_mog_data_parallel(ranks, one, jax_runs):
    P, _, res = ranks
    got = _same_on_all(res, "mog")
    _close(got, one["mog"], f"MoG P={P} against P=1")
    _close(got, jax_runs["mog"], f"MoG P={P} against the JAX package")


def test_sharded_decode_is_exact(ranks, one):
    P, _, res = ranks
    for k, want in one["decode"].items():
        got = np.concatenate([r[f"decode.{k}"] for r in res])
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_threshold_over_ranks(ranks):
    import torch

    from prosper_tpu_torch.core.select import global_quantile_threshold
    from prosper_tpu_torch.engine.stream import host_quantile_threshold
    from prosper_tpu_torch.parallel.mesh import stride_data
    P, wd, res = ranks
    v = np.load(wd / "y_odd.npy")[:, 0]
    valid = np.concatenate([
        (np.arange(b - a) % 5 != 0)
        for a, b in (stride_data(N_ODD, P, r) for r in range(P))
    ]).astype(np.float32)
    keep_n = float(np.ceil(0.4 * valid.sum()))
    want = global_quantile_threshold(torch.from_numpy(v),
                                     torch.from_numpy(valid),
                                     torch.tensor(keep_n)).item()
    assert host_quantile_threshold(v, valid, keep_n) == want
    for r in res:
        assert float(r["thresh_dev"]) == want
        assert float(r["thresh_host"]) == want


def test_cli_multihost_matches_train(ranks, inputs, one):
    import h5py
    P, wd, _ = ranks
    ckpts, F_prev = [], []
    for run in (wd / "cli_p", inputs / "cli_1"):
        with h5py.File(run / "checkpoint.h5", "r") as f:
            assert f.attrs["step"] == 8
            ckpts.append({k: np.asarray(v) for k, v in f["params"].items()})
            F_prev.append(np.asarray(f["extra/F_prev"]))
        with h5py.File(run / "result.h5", "r") as f:
            assert f["F_mean"].shape[0] == 8
    # the ranks' F_prev in stride order; one process keeps its padding
    assert F_prev[0].shape == (N_ODD,)
    np.testing.assert_allclose(F_prev[0], F_prev[1][:N_ODD], rtol=1e-3)
    _close(ckpts[0], ckpts[1], f"train --multihost (P={P}) against train")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]))
