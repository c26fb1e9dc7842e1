"""The port's copies of the exact-diagonalisation modules stay in step with the reference.

``deephall_tpu_torch/observables/ed.py``, ``ed_native.py`` and
``_ed_native.cpp`` are copies of their ``deephall_tpu`` originals, so that the
port imports no JAX.  Line by line, after mapping ``deephall_tpu`` to
``deephall_tpu_torch`` in the original, dropping both module docstrings and
writing the original's citation paths as the copy cites them, the files must
be equal but for :data:`ALLOWED`: the compiled library's cache directory in
``ed_native.py`` (the port builds under ``build/deephall_tpu_torch/`` in the
checkout, the reference under the temporary directory).
"""

from __future__ import annotations

import ast
import difflib
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = ("ed.py", "ed_native.py", "_ed_native.cpp")
# (lines only the original has, lines only the copy has), in file order.
ALLOWED = {
    "ed_native.py": (
        ["import tempfile",
         "    cache_dir = Path(",
         '        os.environ.get("DEEPHALL_NATIVE_CACHE", tempfile.gettempdir())',
         '    ) / "deephall_tpu_native"'],
        ['_BUILD = Path(__file__).resolve().parents[2] / "build"',
         '    cache_dir = Path(os.environ.get("DEEPHALL_NATIVE_CACHE", _BUILD))'
         ' / "deephall_tpu_torch"'],
    ),
}
PACKAGE = re.compile(r"\bdeephall_tpu\b(?!_torch)")
# The original cites the upstream DeepHall sources by their path on disk.
CITATION = re.compile(r"``/[\w.]+/reference/deephall/([^`]+)``")


def without_module_docstring(name: str, text: str) -> list[str]:
    lines = text.splitlines()
    if name.endswith(".py"):
        body = ast.parse(text).body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            del lines[body[0].lineno - 1:body[0].end_lineno]
    return lines


def normalised_original(name: str, text: str) -> list[str]:
    text = CITATION.sub(r"DeepHall's ``\1``", PACKAGE.sub("deephall_tpu_torch", text))
    return without_module_docstring(name, text)


def differences(name: str, original: str, copy: str) -> tuple[list[str], list[str]]:
    """The lines only the (normalised) original has and those only the copy has."""
    a, b = normalised_original(name, original), without_module_docstring(name, copy)
    only_original, only_copy = [], []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes():
        if tag != "equal":
            only_original += a[i1:i2]
            only_copy += b[j1:j2]
    return only_original, only_copy


def read_pair(name: str) -> tuple[str, str]:
    return ((REPO / "deephall_tpu" / "observables" / name).read_text(),
            (REPO / "deephall_tpu_torch" / "observables" / name).read_text())


@pytest.mark.parametrize("name", FILES)
def test_copy_differs_only_where_allowed(name):
    got = differences(name, *read_pair(name))
    assert got == ALLOWED.get(name, ([], [])), got


@pytest.mark.parametrize("name", FILES)
def test_a_changed_line_is_caught(name):
    # One line of the copy outside its module docstring, picked from a numpy
    # seed, with a character appended: the comparison reports it.
    original, copy = read_pair(name)
    lines = copy.splitlines()
    kept = set(without_module_docstring(name, copy))
    candidates = [i for i, line in enumerate(lines) if line.strip() and line in kept]
    i = candidates[np.random.default_rng(len(name)).integers(len(candidates))]
    lines[i] += " "
    got = differences(name, original, "\n".join(lines) + "\n")
    assert got != ALLOWED.get(name, ([], [])) and lines[i] in got[1], (i, got)
