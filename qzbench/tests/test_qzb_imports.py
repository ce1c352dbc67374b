"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the plain reference imports nothing of the program."""
import ast
import os

import pytest

from qzbench import harness

HERE = os.path.join(harness.ROOT, "qzbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "qatzip_tpu"}
# the reference and what it is built from
REFERENCE = ["refs/gzip_ext.py", "refs/lz4_frame.py", "gzipext.py",
             "lz4plain.py", "xxh32.py", "corpus.py"]


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value.split(".")[0]


def _files():
    for d, _, fs in os.walk(HERE):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole():
    assert "qatzip_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "qatzip_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("rel", REFERENCE)
def test_the_reference_imports_nothing_of_the_program(rel):
    tops = set(_tops(os.path.join(HERE, rel)))
    assert not {t for t in tops if t.startswith("qatzip")}, tops


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "qatzip_tpu_torch_fake",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib" in harness.forbidden_modules()
