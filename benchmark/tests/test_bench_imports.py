"""No module of the benchmark, and none that the reference and the data
generator import, has the top-level name of JAX or of the JAX package
(compared whole: the port, prosper_tpu_torch, begins with the JAX
package's name); the reference and the generator import nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import ROOT

SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_stands_apart_from_the_program():
    for name in ("reference.py", "data.py", "metrics/counts.py"):
        tops = set(_imports(ROOT / "benchmark" / name))
        assert tops <= {"__future__", "hashlib", "itertools", "math",
                        "typing", "torch", "benchmark"}, (name, tops)


def test_importing_the_harness_loads_none_of_them():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.reference, benchmark.data\n"
            "import benchmark.drivers.train, benchmark.drivers.decode\n"
            "from benchmark import harness, spec\n"
            "for m in spec.load()['per_layer']: spec.reader(m['name'])\n"
            "print(harness.forbidden_modules(),"
            " 'prosper_tpu_torch' in {m.split('.')[0] for m in sys.modules})"
            % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["[]", "False"]


def test_the_names_are_compared_whole():
    import prosper_tpu_torch  # noqa: F401
    assert "prosper_tpu" not in harness.forbidden_modules()
