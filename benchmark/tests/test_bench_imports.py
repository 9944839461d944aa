"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``tpu_nexus_torch`` begins with ``tpu_nexus``), and
the reference imports nothing of the program."""

import ast

import pytest

from benchmark.common import FORBIDDEN, HERE

SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")) + [HERE / "weights.py", HERE / "roofline.py",
                                                                          HERE / "traffic.py"],
                         ids=lambda p: p.name)
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert "tpu_nexus_torch" not in set(_imports(path))


def test_whole_names_are_compared():
    from benchmark.common import forbidden_modules

    import tpu_nexus_torch  # noqa: F401

    assert "tpu_nexus" not in forbidden_modules() or __import__("sys").modules.get("tpu_nexus")
