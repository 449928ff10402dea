"""The closed loop's window and the reservoir of judged steps."""

import numpy as np

from zkbench.harness import Closed, Sample


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def run_window(durations, warm=1, seconds=10.0):
    clock = Clock()
    win = Closed(warm, seconds, clock)
    step = 0
    for d in durations:
        clock.now += d
        step += 1
        if win.after(step) == "close":
            break
    return win


def test_step_s_is_all_the_time_over_all_the_steps():
    win = run_window([5.0] + [1.0] * 20)
    assert win.steps == 10 and win.t1 - win.t0 == 10.0
    assert win.step_s == 1.0


def test_a_stall_inside_the_window_moves_step_s():
    steady = run_window([5.0] + [1.0] * 20)
    stalled = run_window([5.0, 1.0, 1.0, 4.0] + [1.0] * 20)
    assert stalled.step_s > steady.step_s
    assert stalled.steps == 7 and stalled.step_s == 10.0 / 7


def test_the_warm_up_is_outside_the_window():
    a = run_window([1.0] + [1.0] * 20)
    b = run_window([30.0] + [1.0] * 20)
    assert a.step_s == b.step_s == 1.0


def test_reservoir_is_uniform_over_the_window_and_seeded():
    counts = np.zeros(40)
    for seed in range(2000):
        s = Sample(2, seed)
        for step in range(2, 42):
            s.offer(step)
        for step in s.slots:
            counts[step - 2] += 1
        assert len(set(s.slots)) == 2
    assert counts.min() > 0.6 * counts.mean()
    a, b = Sample(2, 2**31 + 5), Sample(2, 2**31 + 5)
    for step in range(2, 30):
        assert a.offer(step) == b.offer(step)
    assert a.slots == b.slots


def test_chain_step_s_reads_the_window_time_over_its_steps():
    from zkbench import harness
    win = run_window([5.0, 1.0, 1.0, 4.0] + [1.0] * 20)
    seen = harness.Window(win.steps, win.t0, win.t1, None, {}, None)
    assert harness.reader("chain_step_s").read(seen) == win.step_s
    empty = harness.Window(0, 0.0, 0.0, None, {}, None)
    assert harness.reader("chain_step_s").read(empty) is None
