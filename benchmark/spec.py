"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``traffic/<traffic>.json``,
whose ``kind`` names its driver, ``drivers/<kind>.py``.  Its limits for
``correct`` are ``limits/<cell>.json``.  Its per-layer metrics are the
``per_layer`` entries that list it under ``workloads``; each is read by
``metrics/<metric>.py``.  Adding a configuration, a mix, a metric or a
cell adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(spec: Dict, name: str) -> Dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: Dict, cell_: Dict, root: Path = ROOT) -> Dict:
    entry = _named(spec["configs"], cell_["config"], "config")
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    return dict(cfg, name=entry["name"])


def _json(sub: str, name: str, root: Path) -> Dict:
    path = root / "benchmark" / sub / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {sub} file benchmark/{sub}/{name}.json")
    with open(path) as f:
        return json.load(f)


def traffic(cell_: Dict, root: Path = ROOT) -> Dict:
    return dict(_json("traffic", cell_["traffic"], root),
                name=cell_["traffic"])


def limits(cell_: Dict, root: Path = ROOT) -> Dict[str, float]:
    return _json("limits", cell_["name"], root)


def _for(metric: Dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def end_to_end(spec: Dict, cell_: Dict) -> List[Dict]:
    """The cell's end-to-end metrics (``--trace 0``)."""
    return [m for m in spec["end_to_end"] if _for(m, cell_["name"])]


def per_layer(spec: Dict, cell_: Dict) -> List[Dict]:
    """The cell's per-layer metrics (``--trace 1``)."""
    return [m for m in spec["per_layer"] if cell_["name"] in m["workloads"]]


def _module(path: Path, name: str, what: str) -> ModuleType:
    """The module at ``path`` (a metric's name may hold dots, so modules
    are loaded by their path)."""
    if not path.exists():
        raise KeyError(f"no {what} benchmark/{path.parent.name}/{path.name}")
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py``: reads one per-layer metric."""
    return _module(root / "benchmark" / "metrics" / f"{name}.py",
                   f"benchmark.metrics.reader_{name.replace('.', '_')}",
                   f"reader for metric {name!r}:")


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    """``drivers/<kind>.py``: runs a traffic mix of that kind."""
    return _module(root / "benchmark" / "drivers" / f"{kind}.py",
                   f"benchmark.drivers.{kind}", "driver")
