"""The least time of the comb kernels on an H100, frozen here as the
benchmark's yardstick.

The arithmetic is `chip_smoke.py`'s (`fold_ops`, `lin_ops`, `pipes`,
`bound` and the byte counts of its `kernel_checks`), applied to the
launches one IVC step makes at `default_params()`: the fold sum-check's
comb (`fold_round0` over m = 2^17 columns, then `fold_roundr` over
2^17, 2^16, ..., 4) on 2K x TAU = 90 rows, and the lin sum-check's
(`lin_round0` over its 2^14 truncated columns, then `lin_roundr` over
2^14, ..., 4) on the t = 125 Mz rows.  Each input is counted read once and
each output written once.  A field operation's instructions by pipe are
the SASS of `chip_smoke.py`'s probe kernels built from `csrc/field.cuh`,
frozen in `MIX` (see its comment), so a later change to the program does
not move this yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet): HBM at 3.35 TB/s; 132 SMs at the 1980 MHz
# maximum clock; per SM and clock 64 lanes each for the integer FMA pipe
# and the integer ALU, and 4 x 32 thread instructions issued.
HBM_BYTES_PER_S = 3.35e12
SMS, CLOCK_HZ = 132, 1.98e9
PIPE_PER_S = 64 * SMS * CLOCK_HZ
INSTR_PER_S = 128 * SMS * CLOCK_HZ

# SASS instructions of one field operation by pipe: chip_smoke.probe_mix,
# probe kernels built from the program's csrc/field.cuh at commit 2adeb7e
# (nvcc for sm_90a, -O3), read on an NVIDIA H100 80GB HBM3 (700 W) when
# this benchmark was written.
MIX = {
    "add": {"fma": 3.0, "alu": 11.0, "total": 14.0},
    "sub": {"fma": 1.0, "alu": 7.0, "total": 8.0},
    "fq3_mul": {"fma": 108.0703125, "alu": 290.2578125,
                "total": 398.3359375},
    "fq3_square": {"fma": 74.0, "alu": 251.0, "total": 324.9765625},
}
CLASSES = ("fma", "alu", "total")
MUL3, SQR3 = {"fq3_mul": 1}, {"fq3_square": 1}
ADD3, SUB3 = {"add": 3}, {"sub": 3}

# The zkVM CCS's 52 multisets, by size (the frozen reference's
# create_riscv_ccs; the gate families fix them at every parameter set).
MULTISET_SIZES = (3, 1, 1, 7, 7, 7, 7, 7, 7, 1, 2, 2, 2, 2, 3, 2, 2, 1, 2, 1,
                  3, 3, 4, 2, 1, 1, 2, 1, 2, 1, 2, 1, 1, 2, 1, 2, 1, 1, 1, 1,
                  2, 1, 1, 2, 1, 3, 2, 1, 3, 7, 1, 1)

# The main path at default_params(): m = 2^17, K = 15, TAU = 3, t = 125,
# b_small = 2; the lin stack truncated to 2^14 columns, its last 3 rounds
# in the reconstruction tail; the lin comb's points d + 1.
M_COLS, FOLD_ROWS, B_SMALL = 1 << 17, 90, 2
LIN_COLS, LIN_ROWS, LIN_NPTS = 1 << 14, 125, 8


def tally(*terms):
    """Sum of (times, {op: count}) terms -> {op: count}."""
    out = {}
    for times, counts in terms:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + times * v
    return out


def pipes(ops):
    """{"fma", "alu", "total"} instructions of the field operations."""
    return {c: sum(n * MIX[op][c] for op, n in ops.items()) for c in CLASSES}


def fold_ops(rows, q, npts, b_small, fold):
    """Field operations of one fold comb launch (csrc/comb.cu fold_body)."""
    pt0 = 0 if fold else 2
    ev = (npts - pt0) * (b_small - 1)
    per_row = tally((1, SUB3), (2, MUL3), (2 * npts, ADD3),
                    (npts - pt0, SQR3), (npts - pt0, ADD3), (ev, MUL3),
                    (ev, {"sub": 1}))
    if fold:
        per_row = tally((1, per_row), (2, SUB3), (2, MUL3), (2, ADD3))
    return tally((8 * q * rows, per_row), (8 * q * npts, MUL3))


def lin_ops(sizes, q, npts, fold):
    """Field operations of one lin comb launch (csrc/comb.cu lin_body)
    with +-1 constants, over multisets of the given sizes."""
    terms = [(npts, MUL3)]
    for k in sizes:
        terms += [(k, SUB3), (k * npts, ADD3), ((k - 1) * npts, MUL3),
                  (npts, ADD3)]
        if fold:
            terms += [(2 * k, SUB3), (2 * k, MUL3), (2 * k, ADD3)]
    return tally((8 * q, tally(*terms)),)


def least_s(nbytes, work):
    """The least time: the largest of bytes over HBM bandwidth, FMA and
    ALU instructions over their pipes, all instructions over issue."""
    return max(nbytes / HBM_BYTES_PER_S, work["fma"] / PIPE_PER_S,
               work["alu"] / PIPE_PER_S, work["total"] / INSTR_PER_S)


def fold_launch_s(width, fold, rows=FOLD_ROWS, b_small=B_SMALL):
    npts = 2 * b_small
    q = width // (4 if fold else 2)
    nbytes = 8 * (rows * 24 * width + 24 * q + 3 * rows + npts * 24)
    if fold:
        nbytes += 8 * rows * 24 * 2 * q          # the folded rows written
    return least_s(nbytes, pipes(fold_ops(rows, q, npts, b_small, fold)))


def lin_launch_s(width, fold, sizes=None, rows=LIN_ROWS, npts=LIN_NPTS):
    q = width // (4 if fold else 2)
    nbytes = 8 * (rows * 24 * width + 24 * q + npts * 24)
    if fold:
        nbytes += 8 * rows * 24 * 2 * q
    return least_s(nbytes, pipes(lin_ops(sizes or MULTISET_SIZES, q, npts,
                                         fold)))


def halvings(width, last=4):
    out = []
    while width >= last:
        out.append(width)
        width //= 2
    return out


def per_step():
    """{kernel name pattern: (launches a step, least seconds a step)}."""
    fold_r = halvings(M_COLS)
    lin_r = halvings(LIN_COLS)
    return {
        "fold_round0_kernel<": (1, fold_launch_s(M_COLS, False)),
        "fold_roundr_kernel<": (len(fold_r), sum(fold_launch_s(w, True)
                                                 for w in fold_r)),
        "lin_round0_kernel<": (1, lin_launch_s(LIN_COLS, False)),
        "lin_roundr_kernel<": (len(lin_r), sum(lin_launch_s(w, True)
                                               for w in lin_r)),
    }


def roofline_pct(by_kernel, steps):
    """Sum over the modelled kernels of their least time, divided by the
    sum of their measured time, in %, from {trace name: (launches,
    seconds)} over `steps` steps.  A kernel whose launches do not match
    the model's count is left out; None where none is left."""
    least = measured = 0.0
    for pattern, (launches, least_step) in per_step().items():
        hits = [(n, s) for name, (n, s) in by_kernel.items()
                if pattern in name]
        if sum(n for n, _ in hits) != launches * steps:
            continue
        least += least_step * steps
        measured += sum(s for _, s in hits)
    return 100.0 * least / measured if measured else None
