"""BENCHMARK.json and the files it names: every name resolves, every cell
reports what the contract asks, and a configuration, a mix, a metric and a
cell can each be added as files and entries alone."""

from __future__ import annotations

import argparse
import json
import re
import shutil

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves_to_its_files():
    s = spec.load()
    for cell in s["workloads"]:
        cfg = spec.config(s, cell)
        tr = spec.traffic(cell)
        assert spec.driver(tr["kind"]).run_rank
        assert spec.limits(cell)
        assert cfg["dtype"] in ("float32", "bfloat16", "float16")
    for m in s["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    s = spec.load()
    e2e = {m["name"] for m in s["end_to_end"]}
    for cell in s["workloads"]:
        mine = {m["name"] for m in spec.end_to_end(s, cell)}
        assert "setup_s" in mine and len(mine) >= 2, cell["name"]
        layers = spec.per_layer(s, cell)
        assert layers, cell["name"]
        for m in layers:
            assert m["moves"] in mine, (cell["name"], m["name"])
    for m in s["per_layer"]:
        assert m["moves"] in e2e


def test_the_file_keeps_the_contract_shape():
    s = spec.load()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in s[k]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43200 seconds
    rs = s["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _add(root, key, entry):
    p = root / "BENCHMARK.json"
    s = json.loads(p.read_text())
    s[key].append(entry)
    p.write_text(json.dumps(s))


def test_a_cell_is_added_as_data_alone(tiny_root):
    """A configuration, a mix, a metric and a cell, each added as a file
    and an entry: the harness finds them and runs the cell on the CPU."""
    from benchmark import run
    bench = tiny_root / "benchmark"
    cfg = json.loads((bench / "configs" / "bsc_patches.json").read_text())
    cfg["planted"]["sigma"] = 0.5
    (bench / "configs" / "bsc_quiet.json").write_text(json.dumps(cfg))
    _add(tiny_root, "configs", {
        "name": "bsc_quiet", "source": "https://github.com/ml-uol/prosper",
        "file": "benchmark/configs/bsc_quiet.json", "reduced": [],
        "why": "added in a test"})
    tr = json.loads((bench / "traffic" / "em_protocol.json").read_text())
    tr["iterations"] = 10
    (bench / "traffic" / "em_short.json").write_text(json.dumps(tr))
    shutil.copy(bench / "limits" / "bsc_patches_train.json",
                bench / "limits" / "bsc_quiet_short.json")
    _add(tiny_root, "workloads", {
        "name": "bsc_quiet_short", "config": "bsc_quiet",
        "traffic": "em_short", "chips": 1, "why": "added in a test"})
    p = tiny_root / "BENCHMARK.json"
    s = json.loads(p.read_text())
    for m in s["end_to_end"]:
        if m["name"] == "train_rows_per_s":
            m["workloads"].append("bsc_quiet_short")
    p.write_text(json.dumps(s))
    (bench / "metrics" / "runs.train.py").write_text(
        "def read(r):\n    return float(r.counters['runs'])\n")
    _add(tiny_root, "per_layer", {
        "name": "runs.train", "unit": "runs", "better": "higher",
        "source": "program_counter", "layer": "driver (engine/em.py)",
        "moves": "train_rows_per_s", "workloads": ["bsc_quiet_short"]})
    s = spec.load(tiny_root)
    cell = spec.cell(s, "bsc_quiet_short")
    assert [m["name"] for m in spec.per_layer(s, cell)] == ["runs.train"]
    assert spec.reader("runs.train", tiny_root).read(
        argparse.Namespace(counters={"runs": 3})) == 3.0
    args = argparse.Namespace(workload="bsc_quiet_short", seed=2 ** 33 + 5,
                              seconds=0.5, trace=0, started=None)
    ctx = run.context(args, device="cpu", root=tiny_root)
    assert ctx.cfg["planted"]["sigma"] == 0.5
    result, chk = run.run_cell(ctx, args, root=tiny_root)
    assert result["correct"], chk
    assert set(result["metrics"]) == {"setup_s", "train_rows_per_s"}


def test_a_missing_file_is_named():
    s = spec.load()
    with pytest.raises(KeyError, match="traffic"):
        spec.traffic({"traffic": "no_such_mix"})
    with pytest.raises(KeyError, match="no_such_metric"):
        spec.reader("no_such_metric")
    with pytest.raises(KeyError, match="workload"):
        spec.cell(s, "no_such_cell")
