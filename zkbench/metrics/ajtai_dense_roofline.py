"""ajtai_dense_roofline: the dense Ajtai commitments' least time on the
H100 (`ajtai_bounds.py`: the work of each of a step's contractions, kb
from the configuration), over the device time of the kernels they ran,
in %.

The program's span `ajtai.dense` does not wait for the device, which runs
behind the host there, so most of a contraction's kernels start after its
span has closed.  The kernels of a contraction are therefore taken in the
device's stream order: from its witness `digit_split_kernel`, every
following int8 GEMM, `plane_recombine_kernel` and fill (the output's
zeros), up to the last `plane_recombine_kernel` of that run.  By the
program (`TorchNifs._commit_many`, `mxu.contract`) a contraction of
n = 98,815 is 20 launches: the digit split, the fill, then for each of
its 2 chunks 8 `torch._int_mm` (one a slot) and a `plane_recombine`.

The witness split is the first digit split that starts no earlier than
SLACK_US before the span's start mapped onto the device trace's clock
(`progtrace.mapped`), after the previous contraction, and alone: the
claims' contractions (`mxu.ring_contract`) split both operands back to
back, the commitments only the witnesses.

None where the window's spans are not the configuration's (one a
contraction), where the counter `ajtai.dense.witnesses` is not the
configuration's witnesses, or where the GEMMs found differ from the
counter `ajtai.dense.gemms`."""

import re

from zkbench import ajtai_bounds, progtrace

SPAN = "ajtai.dense"
FIRST = "digit_split_kernel"
LAST = "plane_recombine_kernel"
GEMM = re.compile("gemm", re.IGNORECASE)
FILL = re.compile("FillFunctor|Memset")
# How far before its span's mapped start a contraction's digit split may
# appear: the two clocks' mapping error at one instant of a traced window,
# seen up to 1.33 ms on the H100 (the anchors' drift over a 40 s window is
# 350-800 us).  The next lone digit split back is the previous
# contraction's, 25 ms or more away; the claims' come in pairs.
SLACK_US = 5000.0


def is_gemm(name):
    return GEMM.search(name) is not None


def stretches(device, starts):
    """[[(name, start_us, end_us)] of each contraction], one for each
    mapped span start in `starts` (sorted), from the device events
    `device` (sorted by start); None where one is not found."""
    def split(k):
        return 0 <= k < len(device) and FIRST in device[k][0]

    out, i = [], 0
    for s in starts:
        while i < len(device) and not (
                split(i) and device[i][1] >= s - SLACK_US
                and not split(i - 1) and not split(i + 1)):
            i += 1
        if i == len(device):
            return None
        last = None
        for j in range(i + 1, len(device)):
            name = device[j][0]
            if LAST in name:
                last = j
            elif not (is_gemm(name) or FILL.search(name)):
                break
        if last is None:
            return None
        out.append(device[i:last + 1])
        i = last + 1
    return out


def total(w, counter):
    return sum(d.get(counter, 0) for d in progtrace.steps_in(w))


def read(w):
    if w.trace is None or progtrace.anchors(w) is None:
        return None
    spans = progtrace.spans_in(w, SPAN)
    kappa, n, kbs = ajtai_bounds.step_contractions(ajtai_bounds.config())
    if not spans or len(spans) != len(kbs) * w.steps or \
            total(w, "ajtai.dense.witnesses") != sum(kbs) * w.steps:
        return None
    found = stretches(w.trace.device, sorted(
        a for _, a, _ in progtrace.mapped(w, spans)))
    if found is None or sum(is_gemm(e[0]) for st in found for e in st) != \
            total(w, "ajtai.dense.gemms"):
        return None
    least = w.steps * sum(ajtai_bounds.contraction_s(kappa, n, kb)
                          for kb in kbs)
    measured = sum(b - a for st in found for _, a, b in st) / 1e6
    return 100.0 * least / measured if measured > 0 else None
