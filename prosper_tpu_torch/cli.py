"""Command line: train / infer / generate / diagnose.

Counterpart of ``prosper_tpu/cli.py``.  A config is a ``.py`` file (exec'd,
the reference's param files; it must build a model of this package) or a
declarative ``.toml`` / ``.json`` file, which both packages read alike:

  python -m prosper_tpu_torch.cli generate cfg.json -N 100000 -o d.h5
  python -m prosper_tpu_torch.cli train cfg.json --data d.h5 -o out [--scan] [--resume]
  python -m prosper_tpu_torch.cli train cfg.json --data d.h5 -o out --stream 131072
  torchrun --nproc-per-node 4 -m prosper_tpu_torch.cli train cfg.json --data d.h5 -o out --mesh data=4
  python -m prosper_tpu_torch.cli infer cfg.json -c out/checkpoint.h5 --data d.h5
  python -m prosper_tpu_torch.cli diagnose -c out/checkpoint.h5 --gt cfg.json --json

``train`` writes ``result.h5`` and ``metrics.jsonl`` (one row per
iteration) and ``checkpoint.h5`` (every ``checkpoint_every`` iterations and
at the end) into the output directory; ``--resume`` continues from that
checkpoint on the same trajectory.  ``--stream SEG`` trains through
``StreamingEM``: the data stay on the host and pass through the device in
segments of SEG rows.  ``--device`` (default ``cuda``) says
where the data, parameters and random numbers live; ``--device cpu`` runs
the plain PyTorch versions and no kernel.

``--multihost`` trains data-parallel over the ranks ``torchrun`` started
(one process per device, rank r on ``cuda:{LOCAL_RANK}``; NCCL on the card,
gloo with ``--device cpu``), and in one process without ``torchrun``.
``--mesh data=N`` does the same and insists on N ranks.  Each rank reads its
``stride_data`` rows (a config's generated or inline data is cut the same
way), ``EM`` pads every rank to the longest shard, and rank 0 alone writes
the logs and checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import runpy
import sys
from typing import Any, Dict

import numpy as np

from prosper_tpu_torch.io import hdf5

#: the configs of this package (``.py`` configs must build one of its models)
PORT_CONFIGS = "prosper_tpu_torch/examples/barstest/*.py"


def _registry() -> Dict[str, type]:
    from prosper_tpu_torch.models import BSC, DSC, GSC, MCA, MMCA, TSC
    from prosper_tpu_torch.models.mixtures import MoG, MoP
    return {c.__name__.lower(): c
            for c in (BSC, TSC, DSC, MCA, MMCA, GSC, MoG, MoP)}


def _refuse(path: str, why: str):
    return ValueError(
        f"{path} {why}: this command line takes the configs of "
        f"prosper_tpu_torch ({PORT_CONFIGS}) or a declarative .toml/.json "
        "config; a config of the JAX package runs with python -m "
        "prosper_tpu.cli")


#: an import of the JAX package or of JAX (not of this package)
_JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|prosper_tpu)\b",
                         re.MULTILINE)


def load_config(path: str) -> Dict[str, Any]:
    """Load a .py (exec'd, reference-style), .toml or .json config."""
    if path.endswith(".py"):
        with open(path) as f:
            if _JAX_IMPORT.search(f.read()):
                raise _refuse(path, "imports the JAX package")
        ns = {k: v for k, v in runpy.run_path(path).items()
              if not k.startswith("_")}
        if not isinstance(ns.get("model"), tuple(_registry().values())):
            raise _refuse(path, "builds no model of prosper_tpu_torch")
        return ns
    if path.endswith(".toml"):
        import tomllib
        with open(path, "rb") as f:
            return _build_from_decl(tomllib.load(f))
    if path.endswith(".json"):
        with open(path) as f:
            return _build_from_decl(json.load(f))
    raise ValueError(f"unknown config format: {path}")


def _build_from_decl(cfg: Dict) -> Dict[str, Any]:
    """Declarative config -> instantiated model/anneal/data sources."""
    from prosper_tpu_torch.engine.anneal import LinearAnnealing

    out: Dict[str, Any] = {}
    m = dict(cfg["model"])
    cls = _registry()[m.pop("type").lower()]
    out["model"] = cls(**m)

    a = dict(cfg.get("anneal", {}))
    steps = int(a.pop("steps", 100))
    anneal = LinearAnnealing(steps)
    for name, spec in a.items():
        anneal[name] = [tuple(p) for p in spec] if isinstance(spec, list) \
            else spec
    out["anneal"] = anneal

    for k in ("data_h5", "data_dataset", "output", "seed", "N",
              "log_params_every", "gt_params", "checkpoint_every",
              "revive_duplicates", "split_norm_frac", "split_coact",
              "reseed_worst_frac"):
        if k in cfg:
            out[k] = cfg[k]
    return out


def _load_data(cfg: Dict, model, args) -> Dict[str, np.ndarray]:
    """This process's rows: its ``stride_data`` slice of the data set (all
    of it in one process)."""
    from prosper_tpu_torch.data.patches import load_h5_shard
    from prosper_tpu_torch.parallel.mesh import stride_data
    if getattr(args, "data", None):
        return {"y": load_h5_shard(args.data,
                                   cfg.get("data_dataset", "patches"))}
    if "data_h5" in cfg:
        return {"y": load_h5_shard(cfg["data_h5"],
                                   cfg.get("data_dataset", "patches"))}
    if "data" in cfg or "gt_params" in cfg:
        data = cfg.get("data") or model.generate_data(
            cfg["gt_params"], int(cfg.get("N", 1000)),
            seed=int(cfg.get("seed", 0)))
        first, last = stride_data(len(data["y"]))
        return {k: v[first:last] for k, v in data.items()
                if k in ("y", "valid")}
    raise SystemExit("config provides no data (need data / data_h5 / "
                     "gt_params) and --data not given")


def _truncate_logs(out_dir: str, step: int, log_params_every: int) -> None:
    """Rewind result.h5 / metrics.jsonl to checkpoint ``step`` iterations.

    Scalar and vector channels hold one row per iteration; channels of two
    or more dimensions (W) one per iteration that is a multiple of
    ``log_params_every`` (``EM.step_once``'s rule)."""
    h5_path = os.path.join(out_dir, "result.h5")
    if os.path.exists(h5_path):
        k = max(1, int(log_params_every))
        n_big = (step + k - 1) // k       # positions 0, k, 2k, ... < step
        with hdf5.File(h5_path, "a") as f:
            for name in list(f.keys()):
                ds = f[name]
                target = n_big if (ds.ndim - 1) >= 2 else step
                if ds.shape[0] > target:
                    ds.resize(target, axis=0)
    jl_path = os.path.join(out_dir, "metrics.jsonl")
    if os.path.exists(jl_path):
        with open(jl_path) as f:
            lines = f.readlines()
        if len(lines) > step:
            with open(jl_path, "w") as f:
                f.writelines(lines[:step])


def _runtime(args):
    """The ``MeshRuntime`` that ``--mesh data=N`` / ``--multihost`` ask for
    (None for neither, and for ``--multihost`` outside ``torchrun``);
    raises before any file is opened where the ranks do not fit."""
    if not (args.mesh or args.multihost):
        return None
    import torch.distributed as dist

    from prosper_tpu_torch.parallel.mesh import MeshRuntime, init_multihost
    n = None
    if args.mesh:
        m = re.fullmatch(r"data=(\d+)", args.mesh)
        if m is None:
            raise SystemExit(
                f"--mesh takes data=N, got {args.mesh!r}, as the JAX CLI "
                "does (a state axis is MeshRuntime(mesh_shape=(n_data, "
                "n_state), axis_names=(\"data\", \"state\")) in the API)")
        n = int(m.group(1))
    init_multihost(device=args.device)
    if not dist.is_initialized():
        if n is not None:
            raise SystemExit(
                f"--mesh data={n} trains on {n} ranks, one process each: "
                f"start it with torchrun --nproc-per-node {n} -m "
                "prosper_tpu_torch.cli train ...")
        return None          # --multihost with no ranks: one process
    if n is not None and dist.get_world_size() != n:
        raise SystemExit(f"--mesh data={n} needs {n} ranks; torchrun "
                         f"started {dist.get_world_size()}")
    return MeshRuntime(device=args.device)


def cmd_train(args) -> int:
    # before any file is opened: the log handlers truncate in "w" mode
    if args.stream and (args.mesh or args.multihost):
        raise SystemExit("--stream is single-device; drop --mesh/--multihost")
    runtime = _runtime(args)

    from prosper_tpu_torch.engine.em import EM
    from prosper_tpu_torch.engine.stream import StreamingEM
    from prosper_tpu_torch.io.datalog import DataLog, StoreToH5, StoreToJSONL
    from prosper_tpu_torch.models.base import resolve_backend
    from prosper_tpu_torch.parallel.mesh import pprint
    from prosper_tpu_torch.utils import create_output_path, process_index

    cfg = load_config(args.config)
    model = cfg["model"]
    if args.backend:
        if not hasattr(model, "backend"):
            raise SystemExit(f"model {type(model).__name__} has no backend "
                             "selection")
        model.backend = resolve_backend(args.backend)
    anneal = cfg["anneal"]
    data = _load_data(cfg, model, args)

    out_dir = args.output or cfg.get("output")
    if out_dir is None:
        out_dir = create_output_path(os.path.basename(args.config))
    os.makedirs(out_dir, exist_ok=True)

    log_params_every = int(cfg.get("log_params_every", 1))
    ckpt_path = os.path.join(out_dir, "checkpoint.h5")
    common = dict(seed=int(cfg.get("seed", 42)),
                  device=None if runtime is not None else args.device,
                  log_params_every=log_params_every,
                  checkpoint_path=ckpt_path,
                  checkpoint_every=int(cfg.get("checkpoint_every", 25)))
    if args.stream:
        # the data stay on the host and pass through the card in segments
        em = StreamingEM(model, anneal, np.asarray(data["y"], np.float32),
                         seg_size=args.stream, **common)
    else:
        em = EM(model, anneal, {k: v for k, v in data.items()
                                if k in ("y", "valid")},
                revive_duplicates=(tuple(cfg["revive_duplicates"])
                                   if cfg.get("revive_duplicates") else None),
                split_norm_frac=float(cfg.get("split_norm_frac", 0.0)),
                split_coact=bool(cfg.get("split_coact", False)),
                reseed_worst_frac=float(cfg.get("reseed_worst_frac", 0.0)),
                runtime=runtime, **common)
    mode = "w"
    if args.resume and os.path.exists(ckpt_path):
        # parameters, F_prev, the generator's and the revival chain's state;
        # then drop the log rows of the iterations between the checkpoint
        # and the crash, which the appending handlers would duplicate
        step = em.resume(ckpt_path)
        if process_index() == 0:
            _truncate_logs(out_dir, step, log_params_every)
        pprint(f"[train] resuming from {ckpt_path} at step {step}")
        mode = "a"
    em.dlog = dlog = DataLog()
    dlog.set_handler(None, StoreToH5, os.path.join(out_dir, "result.h5"), mode)
    dlog.set_handler(None, StoreToJSONL,
                     os.path.join(out_dir, "metrics.jsonl"), mode)
    try:
        if args.scan and not args.stream:
            # the parameters of each iteration go to result.h5 as run logs
            # them, so a --scan run's log resumes (resume_from_h5) alike
            em.run_scanned(collect_params=True)
        else:
            em.run(verbose=not args.quiet and process_index() == 0)
        em.save_checkpoint(ckpt_path)
    finally:
        dlog.close()
    streamed = f" (streamed, {em.n_seg} segments)" if args.stream else ""
    ranks = (f" on {runtime.n_data_shards} ranks" if runtime is not None
             else "")
    pprint(f"[train] done{streamed}{ranks} -> {out_dir}")
    return 0


def _host(out: Dict) -> Dict[str, np.ndarray]:
    from prosper_tpu_torch.io.datalog import host
    return {k: host(v) for k, v in out.items()}


def cmd_infer(args) -> int:
    import torch

    from prosper_tpu_torch.data.patches import load_h5_shard
    from prosper_tpu_torch.io import checkpoint

    cfg = load_config(args.config)
    model = cfg["model"]
    try:
        params, step, _ = checkpoint.restore(args.checkpoint, args.device)
    except KeyError:
        params, step = checkpoint.resume_from_h5(
            args.checkpoint, param_names=tuple(model.param_names),
            device=args.device)
    y = load_h5_shard(args.data, cfg.get("data_dataset", "patches"))
    out = model.inference(params, {"y": torch.as_tensor(y,
                                                         device=args.device)},
                          top_L=args.top)
    dest = args.output or "inference.h5"
    with hdf5.File(dest, "w") as f:
        for k, v in _host(out).items():
            f.create_dataset(k, data=v)
    print(f"[infer] {y.shape[0]} datapoints -> {dest} (params from step {step})")
    return 0


def cmd_generate(args) -> int:
    from prosper_tpu_torch.data.patches import write_h5_dataset

    cfg = load_config(args.config)
    model = cfg["model"]
    gt = cfg.get("gt_params")
    if gt is None:
        raise SystemExit("config must define gt_params for generate")
    data = model.generate_data(gt, args.N, seed=args.seed)
    dest = args.output or "generated.h5"
    write_h5_dataset(dest, data["y"])
    print(f"[generate] {args.N} datapoints -> {dest}")
    return 0


def cmd_diagnose(args) -> int:
    """Dictionary-health / recovery report on a trained checkpoint (host
    numpy: the parameters are read to the CPU)."""
    from prosper_tpu_torch.data.diagnosis import (dictionary_stats,
                                                  diagnose_recovery,
                                                  format_report)
    from prosper_tpu_torch.io import checkpoint

    try:
        params, step, _ = checkpoint.restore(args.checkpoint, "cpu")
    except (KeyError, OSError):
        if args.checkpoint.endswith(".npz"):
            params, step = dict(np.load(args.checkpoint)), -1
        else:
            params, step = checkpoint.resume_from_h5(
                args.checkpoint, param_names=("W",), device="cpu")
    W = _host(params)["W"]

    gt_W = None
    if args.gt:
        if args.gt.endswith(".npz"):
            z = np.load(args.gt)
            gt_W = np.asarray(z["gtW"] if "gtW" in z else z["W"])
        else:
            gt = load_config(args.gt).get("gt_params")
            if gt is None:
                raise SystemExit(f"{args.gt} defines no gt_params")
            gt_W = np.asarray(gt["W"])

    if gt_W is None:
        st = dictionary_stats(W, support_frac=args.support_frac)
        dead = np.flatnonzero(st["norms"] < 0.1 * st["median_norm"])
        wide = np.flatnonzero(st["support"] >= 1.5 * st["median_support"])
        if args.json:
            print(json.dumps({
                "step": step, "columns": int(W.shape[1]),
                "median_norm": st["median_norm"],
                "median_support": st["median_support"],
                "max_coherence": st["max_coherence"],
                "dead": dead.tolist(), "wide_support": wide.tolist()}))
            return 0
        print(f"[diagnose] {W.shape[1]} columns (step {step}): "
              f"median norm {st['median_norm']:.3g}, median support "
              f"{st['median_support']:.0f}, max coherence "
              f"{st['max_coherence']:.2f}")
        print(f"  dead (norm<0.1x median): {dead.tolist()}")
        print(f"  wide-support (>=1.5x median, blend suspects): "
              f"{wide.tolist()}")
    else:
        rep = diagnose_recovery(W, gt_W, threshold=args.threshold,
                                signed=args.signed,
                                support_frac=args.support_frac)
        if args.json:
            print(json.dumps({
                "step": step,
                "recovered": int(rep["recovered"].size),
                "total": int(rep["cosines"].size),
                "missed_classes": {str(k): v for k, v
                                   in rep["missed_classes"].items()},
                "blends": {str(c): [int(v[0]), int(v[1]), v[2], v[3]]
                           for c, v in rep["blends"].items()},
                "duplicates": [[int(i), int(j), c]
                               for i, j, c in rep["duplicates"]],
                "dead": rep["dead"]}))
            return 0
        print(f"[diagnose] step {step}")
        print(format_report(rep))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prosper-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    backends = ("cuda", "plain", "pallas", "xla")

    pt = sub.add_parser("train", help="run EM training")
    pt.add_argument("config")
    pt.add_argument("--output", "-o", default=None)
    pt.add_argument("--data", default=None, help="HDF5 dataset overriding config")
    pt.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    pt.add_argument("--quiet", "-q", action="store_true")
    pt.add_argument("--resume", action="store_true",
                    help="restart from <output>/checkpoint.h5 if present")
    pt.add_argument("--scan", action="store_true",
                    help="run the iterations through EM.run_scanned (CUDA "
                         "graph replays of the step)")
    pt.add_argument("--backend", choices=backends, default=None,
                    help="E-step backend (linear, max and GSC families): "
                         "cuda / pallas = the kernels, plain / xla = the "
                         "plain PyTorch version")
    pt.add_argument("--mesh", default=None, metavar="data=N",
                    help="data-parallel over N ranks (torchrun "
                         "--nproc-per-node N); fails on another count")
    pt.add_argument("--multihost", action="store_true",
                    help="data-parallel over the ranks torchrun started "
                         "(one process without torchrun)")
    pt.add_argument("--stream", type=int, default=0, metavar="SEG",
                    help="keep the data set on the host and stream it "
                         "through the device in SEG-row segments "
                         "(engine/stream.py; --scan does not apply)")
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("infer", help="posterior decode with trained params")
    pi.add_argument("config")
    pi.add_argument("--checkpoint", "-c", required=True)
    pi.add_argument("--data", required=True)
    pi.add_argument("--output", "-o", default=None)
    pi.add_argument("--top", type=int, default=10)
    pi.add_argument("--device", default="cuda",
                    help="torch device of the decode (default cuda)")
    pi.set_defaults(fn=cmd_infer)

    pg = sub.add_parser("generate", help="sample data from the model")
    pg.add_argument("config")
    pg.add_argument("-N", type=int, default=1000)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--output", "-o", default=None)
    pg.set_defaults(fn=cmd_generate)

    pd = sub.add_parser("diagnose",
                        help="dictionary-health / recovery report")
    pd.add_argument("--checkpoint", "-c", required=True,
                    help="checkpoint.h5 / result.h5 / .npz with W")
    pd.add_argument("--gt", default=None,
                    help=".npz with gtW, or a config defining gt_params; "
                         "omitted -> health stats only")
    pd.add_argument("--threshold", type=float, default=0.8)
    pd.add_argument("--signed", action="store_true",
                    help="match columns by |cosine| (TSC/MMCA-style)")
    pd.add_argument("--support-frac", type=float, default=0.25)
    pd.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    pd.set_defaults(fn=cmd_diagnose)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
