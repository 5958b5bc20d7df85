"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
``tpu_dra_torch`` is not ``tpu_dra``)."""

import ast

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_dra"}
SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.PACKAGE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "tpu_dra_torch" not in top_level_imports(path)


def test_entry_imports_no_torch_at_top():
    assert "torch" not in top_level_imports(spec.PACKAGE / "__main__.py")
    assert "torch" not in top_level_imports(spec.PACKAGE / "spec.py")


def test_run_check_compares_whole_names(monkeypatch):
    from portbench.drivers import train

    loaded = {"tpu_dra_torch": 1, "tpu_dra_torch.workloads.model": 1,
              "jaxtyping": 1, "numpy": 1}
    monkeypatch.setattr(train.sys, "modules", dict(loaded))
    assert train.forbidden_modules() == []
    monkeypatch.setattr(train.sys, "modules",
                        dict(loaded, **{"tpu_dra.api": 1, "jax.numpy": 1}))
    assert train.forbidden_modules() == ["jax", "tpu_dra"]
