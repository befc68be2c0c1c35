"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import os

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "treemorph_tpu"}
BENCH = os.path.join(ROOT, "benchmark")


def sources(sub=""):
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN
    text = open(path).read()
    assert "import_module(\"treemorph_tpu\"" not in text


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_stands_alone(path):
    names = set(top_level_imports(path))
    assert names <= {"__future__", "contextlib", "math", "typing", "numpy",
                     "torch"}, names


def test_the_program_is_reached_only_through_one_module():
    """Outside the tests, which hold the reference to the port."""
    for path in sources():
        if path.endswith(os.path.join("lib", "program.py")) or \
                os.sep + "tests" + os.sep in path:
            continue
        assert "treemorph_tpu_torch" not in set(top_level_imports(path)), path


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "treemorph_tpu_torch_extra", object())
    assert "treemorph_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "treemorph_tpu.models", object())
    assert run.forbidden_modules() == ["treemorph_tpu"]
