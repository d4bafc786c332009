"""The port's two small examples at a reduced size on the CPU:
``prosper_tpu_torch/examples/mca_occlusion.py`` (MCA and BSC on occlusion
scenes, with revival, at the reduced size of tests/test_max_oracle.py:245)
and ``prosper_tpu_torch/examples/mog_clusters.py`` (a config of the port's
command line)."""

import json
import os

import numpy as np

from prosper_tpu_torch import cli
from prosper_tpu_torch.data.bars import cosine_match
from prosper_tpu_torch.examples import mca_occlusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mca_occlusion_runs_both_families(capsys):
    """Both fits run with revival and recover objects; which family wins
    depends on the noise chain (in the JAX package's example too), so the
    test holds the counts to their range and MCA to half the objects."""
    rec_mca, rec_bsc = mca_occlusion.main(N=2048, iters=50, device="cpu")
    assert 4 <= rec_mca <= 8 and 0 <= rec_bsc <= 8
    assert "[occlusion] MCA" in capsys.readouterr().out


def test_planted_objects_are_the_jax_examples():
    W = mca_occlusion.planted_objects(8, 8, 0)
    assert W.shape == (64, 8) and (W.max(axis=0) >= 5.0).all()
    # overlapping rectangles: some pixels belong to several objects
    assert ((W > 0).sum(axis=1) > 1).any()


def test_mog_clusters_config_trains_through_the_cli(tmp_path):
    cfg = os.path.join(ROOT, "prosper_tpu_torch", "examples",
                       "mog_clusters.py")
    out = str(tmp_path / "mog")
    assert cli.main(["train", cfg, "-o", out, "-q", "--device", "cpu"]) == 0
    rows = [json.loads(line)
            for line in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 40 and rows[-1]["F_mean"] > rows[0]["F_mean"]
    loaded = cli.load_config(cfg)
    from prosper_tpu_torch.io import checkpoint
    params, step, _ = checkpoint.restore(os.path.join(out, "checkpoint.h5"),
                                         "cpu")
    _, cos = cosine_match(params["mu"].numpy().T,
                          np.asarray(loaded["gt_params"]["mu"]).T)
    assert step == 40 and cos.min() > 0.99
