"""The device's busy time, idle share and idle gaps from synthetic
intervals (microseconds, as the profiler gives them)."""

import pytest

from zkbench.devtrace import Trace


def trace():
    device = [("k1", 10, 30), ("k2", 20, 40), ("copy", 60, 70),
              ("k3", 95, 120)]               # 120 runs past the window
    ranges = [("fold", 0, 50), ("transcript", 42, 48),
              ("collector", 55, 100)]
    return Trace(sorted(device, key=lambda d: d[1]), ranges, (0, 100))


def test_busy_is_the_union_of_overlapping_intervals():
    t = trace()
    assert t.busy_intervals() == [[10, 40], [60, 70], [95, 100]]
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.window_s() == pytest.approx(100e-6)
    idle = 100.0 * (1 - t.busy_s() / t.window_s())
    assert idle == pytest.approx(55.0)


def test_idle_gaps_go_to_the_innermost_open_span():
    t = trace()
    assert t.idle_gaps() == [(0, 10), (40, 60), (70, 95)]
    got = dict(t.gaps_by_span())
    # (0,10) fold; (40,60): fold 40-42, transcript 42-48, fold 48-50,
    # none 50-55, collector 55-60; (70,95) collector
    assert got["fold"] == pytest.approx(14e-6)
    assert got["transcript"] == pytest.approx(6e-6)
    assert got["(no span)"] == pytest.approx(5e-6)
    assert got["collector"] == pytest.approx(30e-6)
    assert sum(got.values()) == pytest.approx(55e-6)


def test_kernels_by_name_inside_the_window():
    t = trace()
    assert t.by_kernel()["k3"] == (1, pytest.approx(5e-6))
    assert t.top_ops()[0][0] in ("k1", "k2")
