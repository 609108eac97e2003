"""What the benchmark may import: no module under perfbench/ imports JAX or
the JAX package (top-level names compared whole, so the port,
``daft_exprt_tpu_torch``, is not the JAX package), and the plain
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "daft_exprt_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert "daft_exprt_tpu_torch" not in names
    assert names <= {"__future__", "math", "numpy", "torch", "reference"}


def test_whole_names_are_compared():
    assert "daft_exprt_tpu_torch".split(".")[0] not in FORBIDDEN
