"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole, so the port's name passes), and the reference
imports nothing of the port."""

import ast
import os

import pytest

from benchmark import harness

BANNED = {"jax", "jaxlib", "flax", "lyricalignment_tpu"}


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    found = {p: sorted(set(_imports(p)) & BANNED) for p in _sources(harness.HERE)}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.HERE, "reference")
    for p in _sources(ref):
        assert "lyricalignment_tpu_torch" not in set(_imports(p)), p


@pytest.mark.parametrize("name,bad", [("jax.numpy", True), ("lyricalignment_tpu", True),
                                      ("lyricalignment_tpu_torch.api", False),
                                      ("jaxtyping", False)])
def test_top_level_names_compare_whole(name, bad):
    assert (name.split(".")[0] in BANNED) == bad
