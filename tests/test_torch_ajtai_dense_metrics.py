"""The dense Ajtai commitment's yardstick and readers (`zkbench/
ajtai_bounds.py`, `zkbench/metrics/ajtai_dense_roofline.py`,
`prog.ajtai.dense_s.py`, `prog.ajtai.dense_gemms.py`) on the CPU.

  * the least time at the published size: 683,016,192 B of matrix planes,
    a dec contraction (14 witnesses) 0.283 ms, commit_z's (1 witness)
    0.210 ms, both bound by bytes; kb per contraction from the
    configuration's parameters;
  * the readers on a hand-made traced window: the contraction's kernels
    taken in stream order from its witness digit split, also where they
    start after the span has closed; None where the GEMMs found and the
    counter `ajtai.dense.gemms` disagree, where `ajtai.dense.witnesses`
    is not the configuration's, where a span's kernels are missing, and
    without the program's tracer.
"""

import pytest

from latticeum_tpu_torch.host.utils import tracing
from zkbench import ajtai_bounds as ab, harness
from zkbench.devtrace import Trace

KAPPA, N = 32, 98815


def test_the_least_time_at_the_published_size():
    assert ab.plane_bytes(KAPPA, N) == 683_016_192
    assert ab.contraction_bytes(KAPPA, N, 14) == 683_016_192 + 8 * 24 * (
        14 * N + 14 * KAPPA)
    assert ab.contraction_ops(KAPPA, N, 14) == 2 * 864 * 378 * N * 8
    dec = ab.contraction_s(KAPPA, N, 14)
    commit_z = ab.contraction_s(KAPPA, N, 1)
    assert dec == pytest.approx(0.283e-3, abs=0.5e-6)
    assert commit_z == pytest.approx(0.210e-3, abs=0.5e-6)
    # both bound by bytes: the int8 work of a dec contraction is 0.261 ms
    assert ab.contraction_ops(KAPPA, N, 14) / ab.INT8_OPS_PER_S == \
        pytest.approx(0.261e-3, abs=0.5e-6)
    assert dec == ab.contraction_bytes(KAPPA, N, 14) / ab.HBM_BYTES_PER_S
    assert commit_z + 2 * dec == pytest.approx(0.776e-3, abs=0.5e-6)


def test_the_contractions_come_from_the_configuration():
    config = ab.config()
    assert config["name"] == "fib_1mb_dense"
    assert config["scheme"]["kind"] == "general"
    assert ab.step_contractions(config) == (KAPPA, N, [1, 14, 14])
    assert config["published"]["kappa"] == config["params"]["KAPPA"]
    assert config["published"]["K"] == config["params"]["K"]
    bench = harness.manifest()
    conf = next(c for c in bench["configs"] if c["name"] == config["name"])
    assert ab.CONFIG.name == conf["file"].rsplit("/", 1)[1]
    assert conf["reduced"] == ["steps"]


# -- a hand-made window -------------------------------------------------------
GEMM = ("cutlass_80_tensorop_i16832gemm_s8_64x64_64x5_tn_align16")
SPLIT = "void digit_split_kernel(long const*, signed char*, int, int)"
RECOMBINE = "void plane_recombine_kernel(int const*, unsigned long*)"
FILL = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<long>, std::array<char*, 1ul> >")
OTHER = "void ring_mac_kernel(unsigned long const*)"


def contraction(t, gemm_us, chunks=2):
    """The device events of one contraction starting at t us: the digit
    split, the fill, then per chunk 8 GEMMs and a recombination."""
    events = [(SPLIT, t, t + 10), (FILL, t + 10, t + 11)]
    t += 11
    for _ in range(chunks):
        for _ in range(8):
            events.append((GEMM, t, t + gemm_us))
            t += gemm_us
        events.append((RECOMBINE, t, t + 5))
        t += 5
    return events


def us(t):
    """A program instant (s) on the hand-made profiler clock (us)."""
    return (t + 1.0) * 1e6


def claims(t):
    """The device events of a claims' contraction (one chunk) at t us:
    both operands split back to back, the fill, 8 GEMMs, a recombination."""
    return [(SPLIT, t, t + 10), (SPLIT, t + 10, t + 20),
            (FILL, t + 20, t + 21)] + [
        (GEMM, t + 21 + 30 * g, t + 51 + 30 * g) for g in range(8)] + [
        (RECOMBINE, t + 261, t + 265)]


def window(monkeypatch, witnesses=29, gemms=48, drop=None, early=0.0):
    """Two steps, t in [10, 20] s; the profiler's clock 1e6 us ahead.  Each
    step: commit_z's contraction, then dec's two, each span 300 us on the
    host, its kernels 100 us a GEMM on the device (most after the span
    closes), a claims' contraction 1 ms before and 0.4 s after each.  The
    device's events lie `early` us before their true place (the clocks'
    mapping error)."""
    tr = tracing.Tracer(enabled=False)
    device = []
    for step, t0 in enumerate((10.0, 15.0)):
        for k, at in enumerate((0.5, 1.5, 2.5)):
            a = t0 + at
            tr.spans.append(("ajtai.dense", a, a + 300e-6))
            device += claims(us(a) - 1000) + [(OTHER, us(a) - 40,
                                               us(a) + 20)]
            if drop != (step, k):
                device += contraction(us(a) + 30, 100)
            device += claims(us(a + 0.4))
        tr.spans.append((tracing.STEP, t0, t0 + 5.0))
        tr.steps.append((t0, t0 + 5.0, {"ajtai.dense.witnesses": witnesses,
                                        "ajtai.dense.gemms": gemms}))
    device = sorted(((n, a - early, b - early) for n, a, b in device),
                    key=lambda d: d[1])
    monkeypatch.setattr(tracing, "GLOBAL", tr)
    return harness.Window(2, 10.0, 20.0, None, {},
                          Trace(device, [], (11e6, 21e6)))


def read(name, w):
    return harness.reader(name).read(w)


@pytest.mark.parametrize("early", [0.0, 1400.0, 4900.0])
def test_readers_read_a_hand_made_window(monkeypatch, early):
    w = window(monkeypatch, early=early)
    assert read("prog.ajtai.dense_s", w) == pytest.approx(3 * 300e-6)
    assert read("prog.ajtai.dense_gemms", w) == 48.0
    # a contraction's kernels: 10 + 1 + 2 (8 x 100 + 5) us
    measured = 6 * (11 + 2 * 805) * 1e-6
    least = 2 * (ab.contraction_s(KAPPA, N, 1)
                 + 2 * ab.contraction_s(KAPPA, N, 14))
    assert read("ajtai_dense_roofline", w) == pytest.approx(
        100 * least / measured)
    mod = harness.reader("ajtai_dense_roofline")
    spans = [us(a) for n, a, _ in tracing.GLOBAL.spans
             if n == "ajtai.dense"]
    found = mod.stretches(w.trace.device, spans)
    assert [len(s) for s in found] == [20] * 6
    assert all(s[0][1] == a + 30 - early for s, a in zip(found, spans))
    # most of each contraction starts after its span has closed
    assert all(s[-1][1] > a + 300 - early for s, a in zip(found, spans))


@pytest.mark.parametrize("witnesses,gemms,drop,early", [
    (29, 47, None, 0.0),       # the counter and the launches disagree
    (29, 64, None, 0.0),
    (28, 48, None, 0.0),       # witnesses not the configuration's
    (29, 48, (1, 2), 0.0),     # one contraction's kernels missing
    (29, 48, None, 5500.0),    # the clocks further apart than the slack
])
def test_the_roofline_reads_none_where_its_checks_fail(monkeypatch, witnesses,
                                                       gemms, drop, early):
    w = window(monkeypatch, witnesses, gemms, drop, early)
    assert read("ajtai_dense_roofline", w) is None


class _OldTracer:
    """A tracer as a checkout before the program's spans had it."""
    totals, counts = {}, {}


@pytest.mark.parametrize("metric", ["prog.ajtai.dense_s",
                                    "prog.ajtai.dense_gemms",
                                    "ajtai_dense_roofline"])
def test_readers_read_none_without_the_tracer(monkeypatch, metric):
    w = window(monkeypatch)
    monkeypatch.setattr(tracing, "GLOBAL", _OldTracer())
    assert read(metric, w) is None
    monkeypatch.setattr(tracing, "GLOBAL", tracing.Tracer(enabled=False))
    assert read(metric, w) is None
