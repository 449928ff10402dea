"""The torch port stands alone: it imports neither jax nor anything of the
JAX package ``latticeum_tpu``, directly or through the host modules it runs
(its own copies under ``latticeum_tpu_torch/host/``).

Checked two ways: every port module (and ``chip_smoke``) is imported in a
fresh interpreter with both blocked (this test process already holds both:
tests/conftest.py imports jax), and an ``ast`` scan finds no ``import`` or
``from`` of either anywhere in the port's sources or ``chip_smoke.py``,
function-level imports included."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from latticeum_tpu_torch import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = Path(ROOT) / "latticeum_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [Path(ROOT) / "chip_smoke.py"]


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


PORT_MODULES = tuple(_module_name(p) for p in SOURCES)
BLOCKED = ("jax", "latticeum_tpu")

_PROBE = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None       # any import of it now raises ImportError
sys.path.insert(0, {root!r})
importlib.import_module({mod!r})
leaked = sorted(m for m in sys.modules if sys.modules[m] and any(
    m == b or m.startswith(b + ".") for b in {blocked!r}))
assert not leaked, leaked
"""


@pytest.mark.parametrize("mod", PORT_MODULES)
def test_port_module_imports_without_jax(mod):
    res = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(root=ROOT, mod=mod, blocked=BLOCKED)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def _blocked_imports(path):
    """(line, module) of every import of a blocked package in `path`."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
    return found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_source_names_no_jax_package(path):
    assert _blocked_imports(path) == []


def test_blocked_import_scan_sees_nested_imports(tmp_path):
    """The scan catches function-level and dotted imports."""
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from latticeum_tpu.zkvm import prover\n"
                   "    import jax.numpy as jnp\n"
                   "from latticeum_tpu_torch import kernels\n")
    assert _blocked_imports(src) == [(2, "latticeum_tpu.zkvm"),
                                     (3, "jax.numpy")]


def test_prover_host_pieces_run_without_jax():
    """Construct the port's prover on the CPU at small params (the host
    copy: layout, CCS construction, Ajtai scheme) with jax and the JAX
    package blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["latticeum_tpu"] = None
sys.path.insert(0, {root!r})
from latticeum_tpu_torch.host.zkvm.params import resolve
from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver
p = TorchZkVmProver(resolve(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8),
                    device="cpu")
assert p.dn is not None and p.dn.device.type == "cpu"
""".format(root=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


CUDA_SOURCES = sorted((PORT / "csrc").glob("*.cu"))


@pytest.mark.parametrize("source", CUDA_SOURCES,
                         ids=[p.name for p in CUDA_SOURCES])
def test_every_cuda_source_has_a_covered_wrapper_module(source):
    """Each CUDA source of the port is built (kernels.SOURCES), and each of
    its C entry points is launched by name from a port module that the
    tests above import with jax blocked and scan."""
    assert source.name in kernels.SOURCES
    entries = re.findall(r"^int (lt_\w+)\(", source.read_text(), re.M)
    assert entries, source.name
    for name in entries:
        callers = [p for p in SOURCES if p.name != "kernels.py"
                   and f'"{name}"' in p.read_text()]
        assert any(p.is_relative_to(PORT) for p in callers), \
            f"{name} ({source.name}) is launched by no port module"
