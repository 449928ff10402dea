"""The frozen bound functions on a known shape."""

import pytest

from zkbench import bounds


def test_fold_ops_counts_a_round0_launch():
    # one row, one pair, 4 points, b_small 2, round 0: per row and slot
    # 1 sub3 + 2 mul3 + 8 add3 + 2 sqr3 + 2 add3 + 2 mul3 + 2 sub
    ops = bounds.fold_ops(rows=1, q=1, npts=4, b_small=2, fold=False)
    assert ops == {"sub": 8 * (3 + 2), "fq3_mul": 8 * 4 + 8 * 4,
                   "add": 8 * 30, "fq3_square": 8 * 2}


def test_least_time_takes_the_largest_limit():
    work = {"fma": 0.0, "alu": 0.0, "total": 0.0}
    assert bounds.least_s(3.35e12, work) == pytest.approx(1.0)
    work = {"fma": bounds.PIPE_PER_S * 2, "alu": 0.0, "total": 0.0}
    assert bounds.least_s(0, work) == pytest.approx(2.0)
    work = {"fma": 0.0, "alu": 0.0, "total": bounds.INSTR_PER_S * 3}
    assert bounds.least_s(0, work) == pytest.approx(3.0)


def test_per_step_launches_of_the_main_path():
    got = bounds.per_step()
    assert got["fold_round0_kernel<"][0] == 1
    assert got["fold_roundr_kernel<"][0] == 16      # 2^17 ... 4
    assert got["lin_round0_kernel<"][0] == 1
    assert got["lin_roundr_kernel<"][0] == 13       # 2^14 ... 4
    assert all(s > 0 for _, s in got.values())


def test_roofline_share_counts_only_matching_launches():
    per = bounds.per_step()
    steps = 3
    by = {}
    for pat, (n, least) in per.items():
        by[f"void {pat}4>(args)"] = (n * steps, 2 * least * steps)
    assert bounds.roofline_pct(by, steps) == pytest.approx(50.0)
    by["void fold_round0_kernel<4>(args)"] = (2, 1.0)   # not the model's
    pct = bounds.roofline_pct(by, steps)
    assert pct == pytest.approx(50.0)
    assert bounds.roofline_pct({}, steps) is None
