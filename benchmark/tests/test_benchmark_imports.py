"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under benchmark/ (compared by whole top-level name, so the port
syn3r_tpu_torch is allowed), and nothing of the program in reference/."""

import ast
import sys

import pytest

from harness import cli, common

FORBIDDEN = {"jax", "jaxlib", "flax", "syn3r_tpu"}
SOURCES = sorted(p for p in common.BENCH_DIR.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"syn3r_tpu_torch", "harness",
                                          "counts"}


def test_runtime_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "syn3r_tpu_torch_like", sys)
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert cli.forbidden_modules() == ["jaxlib"]
