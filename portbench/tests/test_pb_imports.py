"""What the benchmark's modules may import and read, by top-level module
name compared whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts[len(HERE.parts):])


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "dctpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "dctpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "numpy", "torch", "struct",
                     "zlib", "portbench"}


def test_only_program_py_imports_the_program():
    users = {p.name for p in MODULES if "dctpu_torch" in top_level_imports(p)}
    assert users == {"program.py"}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_package_records(path):
    text = path.read_text()
    for old in ("bench_results", "scaling_results", "BENCH_r0", "MULTICHIP_r0",
                "floors.json", "bench.py", "\"bench/", "'bench/"):
        assert old not in text
