"""On the card (marked `cuda`, at the cell's own size): a sound run comes
out correct, and the control and each fault of the timed path, planted
underneath the harness, come out not correct.

    python -m pytest -m cuda zkbench/tests/test_zkb_faults.py

from the repository's root.  Each case is one run of a few steps:
about two minutes apiece, most of it set-up.
"""

import time

import pytest

from zkbench import harness

CELL = "fib_1mb.loop"
SECONDS = 4.0


def needs_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none here")


def run(fault, seed):
    result, bad, _ = harness.run(CELL, seed, SECONDS, 0,
                                 time.perf_counter(), fault=fault,
                                 log=lambda msg: None)
    return result, bad


@pytest.mark.cuda
def test_a_sound_run_is_correct():
    needs_card()
    result, bad = run(None, 2**31 + 11)
    assert result["correct"], bad


@pytest.mark.cuda
@pytest.mark.parametrize("fault,caught_by", [
    ("partial_transcript", ("fold", "collector")),   # the control
    ("unchanged", ("fold",)),
    ("altered", ("witness",)),
])
def test_a_broken_timed_path_is_not_correct(fault, caught_by):
    needs_card()
    result, bad = run(fault, 2**31 + 12)
    assert not result["correct"]
    assert all(bad[k] > 0 for k in caught_by), bad
