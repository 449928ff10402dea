"""The benchmark loads neither jax nor the JAX package: the run's check of
sys.modules by whole top-level names, and a scan of the benchmark's own
sources (the reference imports nothing of the program either)."""

import ast
from pathlib import Path

import pytest

from zkbench import harness

HERE = Path(harness.__file__).resolve().parent


def forbidden(modules):
    return sorted({m.split(".")[0] for m in modules}
                  & set(harness.FORBIDDEN))


@pytest.mark.parametrize("modules,found", [
    (["latticeum_tpu_torch", "latticeum_tpu_torch.zkvm.prover", "numpy"],
     []),
    (["latticeum_tpu", "latticeum_tpu.zkvm"], ["latticeum_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "latticeum_tpu_torchx"], ["flax"]),
])
def test_top_level_names_compared_whole(modules, found):
    assert forbidden(modules) == found


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
    text = path.read_text()
    assert "bench.py" not in text and "bench/" not in text.replace(
        "zkbench/", "")


REFERENCE = sorted((HERE / "ref").rglob("*.py")) + [
    HERE / "check.py", HERE / "bounds.py"]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(
    p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_program(path):
    for name in imports(path):
        top = name.split(".")[0]
        assert top not in ("latticeum_tpu_torch", "torch", "jax"), (
            path, name)
