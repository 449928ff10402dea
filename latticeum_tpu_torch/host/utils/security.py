"""Security parameter checks and norm helpers.

Mirrors latticefold/src/utils/security_check.rs:5-45: the MSIS bound for
128-bit security with root-Hermite factor delta = 1.0045,
    B_{L2} = 2^(2*sqrt(log2(delta) * d * kappa * log2(q))),
and the protocol requirement B_{L2} > B * sqrt(d * n).
"""

from __future__ import annotations

import math

DELTA = 1.0045
LOG2_Q = 64  # Goldilocks
RING_DEGREE = 24


def msis_l2_bound(kappa: int, degree: int = RING_DEGREE,
                  log2_q: float = LOG2_Q) -> float:
    """log2 of the MSIS L2 bound for the given commitment height."""
    return 2.0 * math.sqrt(math.log2(DELTA) * degree * kappa * log2_q)


def check_ring_modulus_128_bits_security(B: int, kappa: int, n: int,
                                         degree: int = RING_DEGREE) -> bool:
    """True when the decomposition bound B keeps binding under MSIS."""
    log2_required = math.log2(B) + 0.5 * math.log2(degree * n)
    return msis_l2_bound(kappa, degree) > log2_required


def linf_norm(coeffs) -> int:
    """Max balanced-representative magnitude of coefficient-form values."""
    from ..field import host as H
    half = (H.P - 1) // 2
    worst = 0
    for row in coeffs:
        for v in row:
            mag = v if v <= half else H.P - v
            worst = max(worst, mag)
    return worst


def l2_norm_squared(coeffs) -> int:
    from ..field import host as H
    half = (H.P - 1) // 2
    total = 0
    for row in coeffs:
        for v in row:
            mag = v if v <= half else H.P - v
            total += mag * mag
    return total
