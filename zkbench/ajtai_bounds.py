"""The least time of the dense Ajtai commitment on an H100, frozen here as
the benchmark's yardstick of `ajtai_dense_roofline`.

A contraction commits kb witnesses (n ring elements of 24 NTT slots
each) under the dense kappa x n matrix: out[b, k] = sum_i A[k, i] f_b[i],
slot-wise.  Its least time is the larger of its bytes over HBM bandwidth
and its int8 operations over the int8 tensor-core peak, counted from the
work and not from the kernels that do it:

  * bytes: the matrix's int8 digit planes read once (27 kappa plane rows,
    3 Fq3 components x 9 balanced base-256 planes, by the witness length
    padded to the GEMM's depth of 16, by 8 slots), the kb witnesses' u64
    values read once, the (kb, kappa, 24) u64 output written once;
  * int8 operations: 2 x 27 kappa x 27 kb x n x 8 slots.

So it reads the same work whatever implements the contraction (digit
planes and `torch._int_mm`, a fused split, a wgmma kernel).  A step of
the zkVM's IVC loop makes one contraction in `commit_z` (kb = 1) and one
in each of dec's two calls (kb = K - 1 each), read from the
configuration's parameters.
"""

from __future__ import annotations

import json
from pathlib import Path

from .bounds import HBM_BYTES_PER_S

# NVIDIA H100 SXM (data sheet): dense int8 tensor-core rate at 700 W.
INT8_OPS_PER_S = 1.979e15
DIGIT_ROWS = 27          # 3 Fq3 components x 9 digit planes of a value
SLOTS = 8                # NTT slots, each an Fq3 element: 24 u64 a ring
COL_ALIGN = 16           # the planes' columns padded to the GEMM's depth

CONFIG = Path(__file__).resolve().parent / "configs" / "fib_1mb_dense.json"


def plane_bytes(kappa, n):
    """Bytes of the matrix's int8 digit planes."""
    return DIGIT_ROWS * kappa * (-(-n // COL_ALIGN) * COL_ALIGN) * SLOTS


def contraction_bytes(kappa, n, kb):
    return plane_bytes(kappa, n) + 8 * 24 * (kb * n + kb * kappa)


def contraction_ops(kappa, n, kb):
    return 2 * DIGIT_ROWS * kappa * DIGIT_ROWS * kb * n * SLOTS


def contraction_s(kappa, n, kb):
    """The least seconds of one contraction of kb witnesses."""
    return max(contraction_bytes(kappa, n, kb) / HBM_BYTES_PER_S,
               contraction_ops(kappa, n, kb) / INT8_OPS_PER_S)


def step_contractions(config):
    """(kappa, n, [kb of each contraction of a step, in order]) of a
    configuration: commit_z's one witness, then dec's K - 1 twice."""
    p = config["params"]
    return (p["KAPPA"], config["published"]["N"],
            [1, p["K"] - 1, p["K"] - 1])


def config():
    return json.loads(CONFIG.read_text())
