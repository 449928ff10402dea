"""The torch port imports no jax, directly or through the host modules it
reuses.  Checked in a fresh interpreter with jax blocked: this test process
already holds jax (tests/conftest.py imports it)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "latticeum_tpu_torch",
    "latticeum_tpu_torch.field.goldilocks",
    "latticeum_tpu_torch.field.fq3",
    "latticeum_tpu_torch.ring.rq",
    "latticeum_tpu_torch.ring.decompose",
    "latticeum_tpu_torch.zkvm.accel",
    "latticeum_tpu_torch.zkvm.claims",
    "latticeum_tpu_torch.zkvm.comb",
    "latticeum_tpu_torch.zkvm.accel_rounds",
    "latticeum_tpu_torch.zkvm.accel_nifs",
    "latticeum_tpu_torch.zkvm.prover",
    "latticeum_tpu_torch.kernels",
    "latticeum_tpu_torch.convert",
    "chip_smoke",
)

_PROBE = """
import importlib, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {root!r})
importlib.import_module({mod!r})
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m])
assert not leaked, leaked
"""


@pytest.mark.parametrize("mod", PORT_MODULES)
def test_port_module_imports_without_jax(mod):
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, mod=mod)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_prover_host_pieces_run_without_jax():
    """Construct the port's prover on the CPU at small params (the shared
    host modules: layout, CCS construction, Ajtai scheme) with jax blocked."""
    code = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
from latticeum_tpu.zkvm.params import resolve
from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver
p = TorchZkVmProver(resolve(B=1 << 16, L=4, B_SMALL=4, K=8, KAPPA=8),
                    device="cpu")
assert p.dn is not None and p.dn.device.type == "cpu"
""".format(root=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
