"""CPU tests of the benchmark: a copy of it, shrunk to tiny sizes, in a
temporary checkout (``tiny_root``), driven on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the shrunk sizes: widths, rows, iterations, image sizes
TINY_CONFIG = {"bsc_patches": dict(D=16, H=12, Hprime=5, gamma=3, chunk=256),
               "mca_patches": dict(D=16, H=12, Hprime=4, gamma=3, chunk=256)}


def shrink(root: Path) -> None:
    """Make the copy of the benchmark under ``root`` tiny, in place."""
    bench = root / "benchmark"
    for name, sizes in TINY_CONFIG.items():
        p = bench / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(sizes)
        cfg["planted"]["active_pixels"] = 3
        p.write_text(json.dumps(cfg))
    for p in (bench / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        if tr["kind"] == "train":
            tr.update(rows=3000, iterations=20, warmup_iterations=8)
        else:
            tr.update(images=[[20, 20], [24, 24], [28, 24]], pool_rows=4000,
                      rate_per_s=min(tr["rate_per_s"], 50.0))
        p.write_text(json.dumps(tr))


def make_tiny(dest: Path) -> Path:
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shrink(dest)
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny(tmp_path)
