"""The line a run prints last, the checks printed beside it, and the exits
without a card."""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,e2e", [
    ("bsc_patches_train", {"setup_s", "train_rows_per_s"}),
    ("mca_patches_train", {"setup_s", "train_rows_per_s"}),
    ("bsc_patches_decode", {"setup_s", "decode_p95_ms"}),
    ("bsc_patches_decode_sat", {"setup_s", "decode_rows_per_s"})])
def test_the_last_line_of_a_cpu_run(tiny_root, cell, e2e):
    from benchmark import run
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 11, seconds=0.6,
                              trace=0, started=None)
    ctx = run.context(args, device="cpu", root=tiny_root)
    result, chk = run.run_cell(ctx, args, root=tiny_root)
    assert result.pop("reference_s") > 0
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(result, chk)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == e2e
    assert all(m["value"] > 0 and m["unit"] for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = err.getvalue().strip().splitlines()[-len(chk):]
    assert [t.split()[1] for t in tail] == list(chk)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_no_result_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "bsc_patches_train", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA device" in p.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and the benchmark alone."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "bsc_patches_train", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_checks_fail_on_a_number_over_its_limit_or_not_a_number():
    assert harness.passed(harness.checks({"a": 1.0}, {"a": 1.0}))
    assert not harness.passed(harness.checks({"a": 1.5}, {"a": 1.0}))
    assert not harness.passed(harness.checks({"a": float("nan")},
                                             {"a": 1.0}))
    with pytest.raises(KeyError):
        harness.checks({"b": 0.0}, {"a": 1.0})


def test_p95_is_the_exclusive_quantile():
    vals = [float(i) for i in range(1, 101)]
    assert harness.p95(vals) == pytest.approx(95.95)


def test_a_trace_reduces_to_busy_time_and_gaps():
    """The profiler's raw events as the traced runs read them, and the
    reduction: busy time as a union, sums by class, gaps by host
    operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.ones(1000)
        for _ in range(20):
            x = x + 1
    dev, host = trace.raw_events(prof)
    assert not dev and any(n == "aten::add" for n, _, _ in host)
    assert all(e >= s for _, s, e in host)
    s = trace.Summary(
        [("let::rows_kernel(float const*)", 0.0, 1.0),
         ("void sg::nn_kernel<float, true, 4>(float)", 0.5, 1.5),
         ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 3.0, 3.5)],
        [("cudaMalloc", 1.6, 2.9), ("python", 0.0, 4.0)], 4.0)
    assert s.busy_s == 2.0
    assert s.by_class == {"estep.linear": 1.0, "gemm": 1.0,
                          "allreduce": 0.5}
    assert s.seconds("estep.linear", "gemm") == 2.0 and s.has("allreduce")
    assert s.idle_gaps == [("cudaMalloc", 1.5)]
    again = trace.Summary.from_dict(s.as_dict())
    assert again.busy_s == 2.0 and again.idle_gaps == s.idle_gaps
