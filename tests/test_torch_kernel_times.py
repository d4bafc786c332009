"""The edits that ``tools/torch_kernel_times.py ablate`` makes to copies of
the CUDA sources (parts switched off, variants of the kernels) still find
the text they replace: a kernel change that moves it must move the edit
too, or the tool stops on the card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_kernel_times", ROOT / "tools" / "torch_kernel_times.py")
kt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kt)
CSRC = ROOT / "prosper_tpu_torch" / "csrc"


@pytest.mark.parametrize("edit", kt.ABLATIONS + kt.VARIANTS,
                         ids=lambda e: e[0])
def test_edit_finds_its_text(edit):
    name, fname, *rest = edit
    pairs = rest[0] if len(rest) == 1 else [tuple(rest)]
    text = (CSRC / fname).read_text()
    for old, new in pairs:
        assert text.count(old) >= 1, f"{name}: {old!r} not in {fname}"
        assert new != old
