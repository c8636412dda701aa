"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole: the port's `repro_torch` begins with `repro`),
and the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE = ("ref_fedgia.py", "ref_lsq.py", "ref_qwen2.py", "threefry.py",
             "traffic.py", "compare.py", "yardstick.py")
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imports(path: Path):
    """The full names of the modules `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"):
            names.add("__import__")
    return names


def top_level_imports(path: Path):
    return {n.split(".")[0] for n in imports(path)}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not (top_level_imports(path) & FORBIDDEN)
    assert "__import__" not in top_level_imports(path)
    assert not any(n.startswith("repro_torch.benchmarks")
                   for n in imports(path))


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(BENCH / "pbench" / name)
