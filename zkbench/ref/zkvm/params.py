"""zkVM parameters (latticeum/crates/zkvm/src/ccs.rs:23-69).

Parametric where the reference hand-syncs constants: `resolve()` fixes the
CCS_S / layout size cycle by iteration, and asserts the reference values for
the production config.
"""

from __future__ import annotations

from dataclasses import dataclass

# Poseidon2 shape
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 22
SBOX_DEGREE = 7
P2_OUT = 4
P2_WIDTH = 16
P2_RATE = 12
SPONGE_PASSES = 2  # 13 preimage elements / rate 12 -> 2 passes

N_REGS = 32

# fixed by the gate families (builder asserts)
CCS_NUM_MATRICES = 125
CCS_C = 52


@dataclass(frozen=True)
class ZkVmParams:
    B: int = 1 << 15
    L: int = 5
    B_SMALL: int = 2
    K: int = 15
    KAPPA: int = 32
    TAU: int = 3
    X_ELEMS: int = 4           # h_i digits as public input
    ccs_s: int = 17            # log2(m); resolved, asserted for defaults

    @property
    def lin_degree(self) -> int:
        # evals per linearization sum-check round (ccs.rs:63-66)
        return SBOX_DEGREE + 1 + 1

    @property
    def fold_evals(self) -> int:
        return 2 * self.B_SMALL + 1

    @property
    def t(self) -> int:
        return CCS_NUM_MATRICES

    @property
    def q(self) -> int:
        return CCS_C


def resolve(B=1 << 15, L=5, B_SMALL=2, K=15, KAPPA=32) -> ZkVmParams:
    """Fix CCS_S by iterating layout-size <-> m until stable."""
    from .layout import CCSLayout
    ccs_s = 1
    for _ in range(40):
        p = ZkVmParams(B=B, L=L, B_SMALL=B_SMALL, K=K, KAPPA=KAPPA,
                       ccs_s=ccs_s)
        layout = CCSLayout(p)
        n = layout.z_size
        W = layout.w_size * L
        m = max((n - p.X_ELEMS - 1) * L, W)
        new_s = (m - 1).bit_length()
        if new_s == ccs_s:
            return p
        ccs_s = new_s
    raise RuntimeError("ccs_s did not converge")


DEFAULT = None


def default_params() -> ZkVmParams:
    global DEFAULT
    if DEFAULT is None:
        DEFAULT = resolve()
        # reference constants (ccs.rs:43-69)
        from .layout import CCSLayout
        lay = CCSLayout(DEFAULT)
        assert DEFAULT.ccs_s == 17, DEFAULT.ccs_s
        assert lay.w_size == 19763, lay.w_size
        assert lay.z_size == 19768, lay.z_size
        assert lay.w_size * DEFAULT.L == 98815
    return DEFAULT
