"""Nothing under benchmark/ imports JAX or the JAX package; the reference
imports nothing of the port either; nothing reads the JAX-era benchmark files."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "deephall_tpu"}
# Built from parts so that this file does not name them whole.
JAX_ERA = ("bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_", "BASELINE" + ".json")


def _imports(path: Path) -> set[str]:
    """The top-level names of every import of ``path`` (whole names, not prefixes)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_jax_anywhere():
    for path in _sources():
        assert not _imports(path) & JAX, path


def test_whole_names_are_compared():
    assert "deephall_tpu_torch".split(".")[0] not in JAX


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = _imports(path)
        assert "deephall_tpu_torch" not in names and not names & JAX, path
        assert names <= {"__future__", "io", "math", "pickle", "zipfile", "typing", "numpy", "torch",
                         "benchmark"}, (path, names)


def test_no_jax_era_benchmark_file_is_read():
    for path in _sources():
        if path == Path(__file__).resolve():
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not any(p in node.value for p in JAX_ERA if "\n" not in node.value), (path, node.value)
