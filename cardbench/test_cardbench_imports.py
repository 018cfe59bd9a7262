"""Nothing the benchmark runs imports JAX or the JAX package, by whole
top-level module name (``repro_torch`` is not ``repro``), and the plain
references import nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "test_" not in p.name)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the reference models, their blocks and the yardstick never see the program
REFERENCE = [HERE / "cbench" / n for n in ("plain.py", "counts.py",
                                            "weights.py", "traffic.py")] \
    + sorted((HERE / "configs").glob("*.py"))


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 10 and all(p.is_file() for p in REFERENCE)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_jax_package(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_names(path)


def test_loaded_modules_compared_by_whole_top_name(monkeypatch):
    """The run's look at ``sys.modules`` after the window: JAX, jaxlib,
    flax or the JAX package refuse the run; the port does not."""
    import sys
    from cbench import harness
    fake = {n: None for n in ("torch", "repro_torch", "repro_torch.models",
                              "reprox", "jaxtyping")}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake.update({"jax.numpy": None, "repro.models": None})
    assert harness.forbidden_modules() == ["jax", "repro"]
    with pytest.raises(harness.Refused):
        harness.Cell.check_modules(None)
