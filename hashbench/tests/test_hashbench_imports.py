"""What hashbench may load and open: no JAX and no JAX package anywhere,
nothing of the program in the reference, no path of the older harnesses."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HB = Path(__file__).resolve().parents[1]
ROOT = HB.parent
NEVER = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HB.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_sources_are_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: repro_torch is not repro
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((HB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "dataclasses", "math", "typing",
                     "numpy", "torch", "hashbench"}
    text = path.read_text()
    assert "hashbench.loops" not in text and "hashbench.gen" not in text


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HB)))
def test_no_path_of_the_older_harnesses(path):
    if path.name == Path(__file__).name:
        return
    text = path.read_text()
    for old in ("benchmarks/", "portbench", "BENCH_"):
        assert old not in text


def test_loading_the_reference_loads_no_program_and_no_jax():
    code = ("import sys; import hashbench.reference.hashing, "
            "hashbench.reference.linear, hashbench.reference.tron; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro', "
            "'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"
