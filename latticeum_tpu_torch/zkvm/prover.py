"""The IVC prover with the fold step on a torch device.

``TorchZkVmProver`` is the JAX package's ``ZkVmProver`` with its fold engine
swapped for ``TorchNifs``: arithmetization, the verifier-vars collector,
the state commitments and the IVC loop (``prove_vm``) run unchanged on the
host, and ``commit_z`` plus the NIFS fold run as torch tensors on `device`.

    TorchZkVmProver(device="cuda").prove_vm(vm, max_steps=...)
"""

from __future__ import annotations

import torch

from latticeum_tpu.zkvm.prover import ZkVmProver

from ..convert import ajtai_rows
from ..field import goldilocks as gl
from .accel import Engine
from .accel_nifs import TorchNifs


class TorchZkVmProver(ZkVmProver):
    def __init__(self, params=None, scheme_seed: int = 0, device="cuda",
                 log=None):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchZkVmProver(device='cuda'): no CUDA device")
        super().__init__(params, scheme_seed=scheme_seed, device=False,
                         log=log)
        if not getattr(self.scheme, "row_constant", False):
            raise ValueError("the torch fold step needs a row-constant "
                             "Ajtai matrix")
        self.dn = TorchNifs(Engine(self.ccs, dev), self.ccs, self.params,
                            gl.to_int_lists(ajtai_rows(self.scheme)))
