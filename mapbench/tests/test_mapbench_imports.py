"""Nothing under mapbench/ imports JAX or the JAX package, compared by whole
top-level names; the plain reference imports nothing of the program; no
module reads the benchmark scripts written before the port."""

import ast
import os
import sys

import pytest

from mapbench import cell as cells
from mapbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "gnumap_tpu"}


def _sources(sub=""):
    base = os.path.join(cells.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _imports(path):
    return {m.split(".", 1)[0] for m in _modules(path)}


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN
    assert "bench" not in _imports(path)
    assert "gnumap_tpu_torch.bench" not in set(_modules(path))


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "gnumap_tpu_torch" not in _imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnumap_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnumap_tpu.config", sys)
    assert run.forbidden_modules() == ["gnumap_tpu"]
