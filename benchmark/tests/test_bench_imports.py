"""No file of the benchmark imports JAX, the JAX package, its benchmark or
the port's smoke run; the reference imports nothing of the port. Top-level
module names are compared whole (the port's name begins with the JAX
package's)."""

import ast
import os

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "vit_search_tpu", "bench", "chip_smoke"}


def python_files(folder):
    for dirpath, _, names in os.walk(folder):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(python_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(python_files(os.path.join(BENCH, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "vit_search_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    assert "vit_search_torch" not in FORBIDDEN
    assert "vit_search_torch".split(".")[0] != "vit_search_tpu"
