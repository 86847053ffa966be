"""Each frozen copy in ``benchlib/frozen.py`` is its original in
``chip_smoke.py``, statement for statement (read as source, not
imported)."""

import ast
import os

import pytest

from conftest import BENCH, ROOT

NAMES = ("PEAK_BYTES", "PEAK_BF16", "PEAK_F32", "L2_BYTES", "bound", "nbytes")


def definitions(path):
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                out[getattr(target, "id", None)] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_copy_equals_original(name):
    copy = definitions(os.path.join(BENCH, "benchlib", "frozen.py"))
    original = definitions(os.path.join(ROOT, "chip_smoke.py"))
    assert copy[name] == original[name]
