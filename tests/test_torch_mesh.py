"""The port's runtime module (``prosper_tpu_torch/parallel/mesh.py``) in one
process, on the CPU, and ``ETModel.step``.

``ETModel.step`` against the JAX package's ``step`` (rtol 1e-4, as the other
step parities); ``stride_data`` against the JAX package's; the ``maybe_*``
collectives as the identity without a group; and a one-rank gloo group (a
file store in a temporary directory), under which every entry point
(``EM.run``, ``EM.run_scanned``, ``StreamingEM``, ``inference``) equals the
run without a runtime bit for bit, for BSC, MCA, GSC and MoG, with the Ncut
cut, ``partial`` and revival on.  The runs across processes are in
tests/test_torch_multiprocess.py.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from prosper_tpu.engine.anneal import LinearAnnealing as JAnneal
from prosper_tpu.models import linear as jlinear
from prosper_tpu.models.base import make_blank_data as j_blank
from prosper_tpu.parallel import mesh as jmesh
from prosper_tpu_torch import EM, LinearAnnealing, MeshRuntime, StreamingEM
from prosper_tpu_torch.core.select import global_quantile_threshold
from prosper_tpu_torch.engine.stream import host_quantile_threshold
from prosper_tpu_torch.io.weights import params_from_numpy
from prosper_tpu_torch.models import BSC, GSC, MCA, TSC
from prosper_tpu_torch.models.base import (device_sched, make_blank_data,
                                           sched_floats)
from prosper_tpu_torch.models.mixtures import MoG
from prosper_tpu_torch.parallel import mesh

D = 16


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    """A MeshRuntime over a one-rank gloo group on the CPU."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield MeshRuntime(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def y():
    return (np.random.default_rng(0).standard_normal((300, D)) * 2.0
            ).astype(np.float32)


def _anneal(steps=8, partial=True):
    a = LinearAnnealing(steps)
    a["T"] = [(0.0, 1.5), (0.6, 1.0)]
    a["Ncut_factor"] = [(0.0, 0.0), (0.3, 0.0), (0.8, 1.0)]
    a["W_noise"] = [(0.0, 0.3), (0.5, 0.0)]
    if partial:
        a["partial"] = [(0.0, 0.7), (0.5, 1.0)]
    return a


def _same(a, b):
    """Two runs went the same way, bit for bit: parameters, F_prev, every
    scalar of every iteration, the generator's state."""
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.data["F_prev"], b.data["F_prev"])
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert {k: v for k, v in ha.items() if k != "dt"} == \
            {k: v for k, v in hb.items() if k != "dt"}
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# -- ETModel.step -------------------------------------------------------------


@pytest.mark.parametrize("family", ["bsc", "tsc"])
def test_step_matches_jax(family):
    """``model.step(params, data, anneal, generator)`` against the JAX
    package's ``step(params, data, anneal, rng)``: one iteration with the
    Ncut cut on, (params, data with F_prev = F, scalars)."""
    jcls, tcls = {"bsc": (jlinear.BSC, BSC), "tsc": (jlinear.TSC, TSC)}[family]
    H, Hp, gamma, N = 10, 5, 3, 256
    jm, tm = jcls(D, H, Hp, gamma, chunk=64), tcls(D, H, Hp, gamma, chunk=64)
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((N, D)) * 2.0).astype(np.float32)
    F_prev = (rng.standard_normal(N) * 5 - 40).astype(np.float32)
    p_np = {k: np.asarray(v) for k, v in
            jm.standard_init({"y": y}, seed=1).items()}
    a, ja = LinearAnnealing(10), JAnneal(10)
    for an in (a, ja):
        an["T"] = 1.5
        an["Ncut_factor"] = 0.6
    import jax
    import jax.numpy as jnp
    p_j, d_j, s_j = jm.step({k: jnp.asarray(v) for k, v in p_np.items()},
                            dict(j_blank(y), F_prev=jnp.asarray(F_prev)), ja,
                            jax.random.PRNGKey(0))
    data = dict(make_blank_data(y, device="cpu"), F_prev=torch.tensor(F_prev))
    p_t, d_t, s_t = tm.step(params_from_numpy(p_np, "cpu"), data, a,
                            torch.Generator())
    assert a.position == 0
    for k in p_j:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(d_t["F_prev"].numpy(),
                               np.asarray(d_j["F_prev"]), rtol=1e-4)
    assert d_t["y"] is data["y"]
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-4,
                                   err_msg=k)


# -- the helpers ----------------------------------------------------------------


def test_stride_data_matches_jax():
    for N in (0, 1, 7, 100, 513, 4096, 10**6 + 3):
        for P in (1, 2, 3, 4, 7, 8):
            bounds = [mesh.stride_data(N, P, i) for i in range(P)]
            assert bounds == [jmesh.stride_data(N, P, i) for i in range(P)]
            assert bounds[0][0] == 0 and bounds[-1][1] == N
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_collectives_without_a_group_are_the_identity():
    x = torch.randn(5)
    for f in (mesh.maybe_psum, mesh.maybe_pmax, mesh.maybe_pmin):
        assert f(x, None) is x
    tree = {"a": x, "b": torch.zeros(())}
    assert mesh.psum_dict(tree, None) is tree
    mesh.init_multihost(device="cpu")        # no torchrun, no arguments
    assert not dist.is_initialized()


def test_runtime_needs_a_group():
    with pytest.raises(RuntimeError, match="init_multihost"):
        MeshRuntime(device="cpu")
    with pytest.raises(ValueError, match="together"):
        mesh.init_multihost("127.0.0.1:1", device="cpu")


def test_one_rank_collectives_keep_every_bit(rt):
    x = torch.randn(7) * 1e3
    for f in (mesh.maybe_psum, mesh.maybe_pmax, mesh.maybe_pmin):
        before = x.clone()
        assert f(x, rt.group) is x and torch.equal(x, before)
    s = torch.randn(())
    assert torch.equal(mesh.maybe_psum(s.clone(), rt.group), s)
    tree = {"xs": torch.randn(16, 10), "n": torch.tensor(3.0),
            "i": torch.arange(5), "ss": torch.randn(10, 10)}
    out = mesh.psum_dict(tree, rt.group)
    assert list(out) == list(tree)
    for k in tree:
        assert out[k].shape == tree[k].shape and torch.equal(out[k], tree[k])
        # each view starts 128 elements into its buffer (512 bytes for
        # float32: on the card as aligned as a tensor of its own)
        assert out[k].storage_offset() % 128 == 0


def test_replication_error(rt):
    p = {"W": torch.randn(4, 3), "pi": torch.tensor(0.2)}
    assert float(mesh.replication_error(p, rt.group)) == 0.0
    assert float(mesh.replication_error([p["W"]], rt.group)) == 0.0
    assert float(mesh.replication_error({}, rt.group)) == 0.0


def test_state_axis_is_state_sharding(rt, y):
    """The ("data", "state") grid where one process can check it: the rank
    lists of its columns (data groups) and rows (state groups), row-major
    as the JAX runtime's ``reshape(mesh_shape)``; the (1, 2) grid needs two
    ranks, so this one-rank world refuses it by its size; a state axis of
    one shard builds the data-only runtime; the step's state keywords are
    checked (state_sharded)."""
    assert mesh.grid_groups((1, 2)) == ([[0], [1]], [[0, 1]])
    assert mesh.grid_groups((2, 2)) == ([[0, 2], [1, 3]], [[0, 1], [2, 3]])
    assert mesh.grid_groups((4, 1)) == ([[0, 1, 2, 3]],
                                        [[0], [1], [2], [3]])
    with pytest.raises(ValueError, match="2 shards"):
        MeshRuntime(device="cpu", mesh_shape=(1, 2),
                    axis_names=("data", "state"))
    one = MeshRuntime(device="cpu", mesh_shape=(1, 1),
                      axis_names=("data", "state"))
    assert one.n_data_shards == 1 and one.data_axis == "data"
    assert one.n_state_shards == 1 and (one.data_index,
                                        one.state_index) == (0, 0)
    assert one.data_group is one.group and one.state_group is None
    assert one.data_host_group is one.host_group
    model = BSC(D, 8, 4, 3)
    assert one.state_kwargs(model.step_fn) == {}
    assert one.shard_step(model.step_fn).keywords == {"group": one.group}
    with pytest.raises(ValueError, match="2 shards"):
        MeshRuntime(device="cpu", mesh_shape=(2,))
    with pytest.raises(ValueError, match="'state' axis"):
        MeshRuntime(device="cpu", mesh_shape=(1, 1, 2),
                    axis_names=("data", "state", "model"))
    assert not mesh.state_sharded(None, 1)
    assert not mesh.state_sharded(rt.group, 1)
    with pytest.raises(ValueError, match="2 ranks|1 ranks"):
        mesh.state_sharded(rt.group, 2)
    params = model.standard_init({"y": y}, device="cpu")
    sched = device_sched(sched_floats(LinearAnnealing(2)), "cpu")
    yt = torch.from_numpy(y)
    with pytest.raises(ValueError, match="state group"):
        model.estep_sums(params, yt, torch.ones(len(y)), sched,
                         n_state_shards=2)


def test_host_collectives(rt):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert np.array_equal(rt.all_gather_host(a)[0], a)
    assert np.array_equal(rt.gather_host(a)[0], a)
    assert np.array_equal(rt.broadcast_host(a), a)
    assert rt.allreduce_host(np.float32(2.5), "min") == np.float32(2.5)
    assert list(rt.n_locals(7)) == [7]
    assert np.array_equal(rt.stride_order(torch.arange(6.0), [4]),
                          np.arange(4.0))
    placed = rt.shard_data({"y": a, "valid": torch.ones(2)})
    assert placed["y"].device == rt.device and torch.equal(
        placed["y"], torch.from_numpy(a))
    v = np.random.default_rng(1).standard_normal(200).astype(np.float32)
    valid = (np.arange(200) % 3 != 0).astype(np.float32)
    assert (host_quantile_threshold(v, valid, 50.0,
                                    allreduce=rt.allreduce_host)
            == host_quantile_threshold(v, valid, 50.0)
            == global_quantile_threshold(
                torch.from_numpy(v), torch.from_numpy(valid),
                torch.tensor(50.0), group=rt.group).item())


# -- one rank equals no runtime, bit for bit ------------------------------------


@pytest.mark.parametrize("family", ["bsc", "mca", "gsc", "mog"])
def test_em_under_one_rank_equals_em(rt, y, family):
    model = {"bsc": BSC(D, 8, 4, 3, chunk=64), "mca": MCA(D, 8, 4, 3, chunk=64),
             "gsc": GSC(D, 8, 4, 3, chunk=64), "mog": MoG(D, 4)}[family]
    revive = None if family == "mog" else (2, 0.5)
    p0 = model.standard_init({"y": y}, device="cpu")
    a = EM(model, _anneal(), {"y": y}, params=p0, device="cpu", seed=3,
           revive_duplicates=revive)
    a.run()
    b = EM(model, _anneal(), {"y": y}, params=p0, seed=3, runtime=rt,
           revive_duplicates=revive)
    assert b.device == torch.device("cpu")
    b.run()
    _same(a, b)
    assert a.revival_stats == b.revival_stats
    # the default init reads every rank's rows: here the only rank's
    c = EM(model, _anneal(2), {"y": y}, device="cpu")
    d = EM(model, _anneal(2), {"y": y}, runtime=rt)
    for k in c.params:
        assert torch.equal(c.params[k], d.params[k]), k


def test_run_scanned_under_one_rank_equals_run(rt, y):
    """On the CPU ``run_scanned`` is the plain loop, gloo included."""
    model = BSC(D, 8, 4, 3, chunk=64)
    p0 = model.standard_init({"y": y}, device="cpu")
    a = EM(model, _anneal(), {"y": y}, params=p0, device="cpu", seed=3)
    a.run()
    b = EM(model, _anneal(), {"y": y}, params=p0, seed=3, runtime=rt)
    b.run_scanned(3)
    b.run()
    _same(a, b)


def test_checkpoint_and_resume_under_one_rank(rt, y, tmp_path):
    model = BSC(D, 8, 4, 3, chunk=64)
    p0 = model.standard_init({"y": y[:250]}, device="cpu")
    full = EM(model, _anneal(), {"y": y[:250]}, params=p0, seed=3,
              runtime=rt, revive_duplicates=(2, 0.5))
    full.run()
    ckpt = str(tmp_path / "ckpt.h5")
    cut = EM(model, _anneal(), {"y": y[:250]}, params=p0, seed=3,
             runtime=rt, revive_duplicates=(2, 0.5), checkpoint_path=ckpt,
             checkpoint_every=3)
    for _ in range(4):
        cut.step_once()
    import h5py
    with h5py.File(ckpt) as f:     # the rows without the padding to 256
        assert f["extra/F_prev"].shape == (250,)
    res = EM(model, _anneal(), {"y": y[:250]}, params=p0, seed=3,
             runtime=rt, revive_duplicates=(2, 0.5))
    assert res.resume(ckpt) == 3
    res.run()
    for k in full.params:
        assert torch.equal(full.params[k], res.params[k]), k
    assert torch.equal(full.data["F_prev"], res.data["F_prev"])


def test_streaming_under_one_rank_equals_streaming(rt, y):
    model = BSC(D, 8, 4, 3, chunk=32)
    p0 = model.standard_init({"y": y}, device="cpu")
    a = StreamingEM(model, _anneal(), y, seg_size=64, params=p0, seed=3,
                    device="cpu")
    a.run()
    b = StreamingEM(model, _anneal(), y, seg_size=64, params=p0, seed=3,
                    runtime=rt)
    b.run()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.F_prev, b.F_prev)
    assert [h["n_used"] for h in a.history] == [h["n_used"] for h in
                                                b.history]


@pytest.mark.parametrize("family", ["bsc", "mca", "gsc"])
def test_inference_under_one_rank_equals_inference(rt, y, family):
    model = {"bsc": BSC(D, 8, 4, 3), "mca": MCA(D, 8, 4, 3),
             "gsc": GSC(D, 8, 4, 3)}[family]
    p = model.standard_init({"y": y}, device="cpu")
    a = model.inference(p, {"y": y[:40]}, top_L=3)
    b = model.inference(p, {"y": y[:40]}, top_L=3, runtime=rt)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_runtime_argument_checks(rt, y):
    with pytest.raises(ValueError, match="runtime's device"):
        EM(BSC(D, 8, 4, 3), _anneal(), {"y": y}, device="cuda", runtime=rt)
    with pytest.raises(TypeError, match="MeshRuntime"):
        StreamingEM(BSC(D, 8, 4, 3, chunk=32), _anneal(), y, seg_size=64,
                    runtime=object())
