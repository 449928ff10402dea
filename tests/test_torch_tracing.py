"""The port's tracer (host/utils/tracing.py) and the benchmark's readers of it.

  * off, it records nothing; a torch.profiler session turns it on, and
    closing the session turns it off;
  * spans nest, timers count an inner call once, and the counters become
    one record a `step` span;
  * `transcript.perms` equals the permutations the pure-Python
    DuplexChallenger runs on the same absorb/sample sequence;
  * every C entry point of kernels.SIGNATURES is reached through a wrapper
    that counts its launches, and the registry lists them all;
  * two CPU `prove_vm` steps at small parameters give one step record a
    step, each layer span once a step, and `prover.timings` its keys (with
    the fold step's costliest CPU twins stubbed by shape-true stand-ins;
    on the real twins too, marked slow);
  * the benchmark's readers (zkbench/progtrace.py, zkbench/metrics/prog.*)
    read a hand-made window, and read None without the tracer.
The parity with the JAX package's tracer is tests/test_torch_serialize.py.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from latticeum_tpu_torch import kernels
from latticeum_tpu_torch.host.crypto import native, poseidon2_ref as p2
from latticeum_tpu_torch.host.crypto.transcript import Transcript
from latticeum_tpu_torch.host.utils import tracing
from zkbench import harness, progtrace
from zkbench.devtrace import Trace

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "latticeum_tpu_torch"


@pytest.fixture
def fresh(monkeypatch):
    """The process tracer, emptied, following the process (not the
    environment: LATTICEUM_TRACE is taken as unset)."""
    monkeypatch.setattr(tracing, "ENV", False)
    monkeypatch.setattr(tracing, "GLOBAL", tracing.Tracer())
    return tracing.GLOBAL


def test_off_tracer_records_nothing(fresh):
    assert not tracing.active()
    assert tracing.span("x") is tracing.OFF
    assert tracing.timer("t") is tracing.OFF
    t = Transcript()
    t.absorb_slice([[1] * 24, [2] * 24])
    t.get_challenge()
    with tracing.span(tracing.STEP):
        with tracing.span("inner"):
            pass
    assert not fresh.spans and not fresh.steps and not fresh.counters
    assert not fresh.totals
    off = tracing.Tracer(enabled=False, log=print)
    assert off.span("x") is tracing.OFF and off.timer("t") is tracing.OFF
    timings = {}
    with tracing.span("keyed", timings, "k"):
        pass
    assert len(timings["k"]) == 1 and not fresh.spans


def test_profiler_session_turns_the_tracer_on_and_off(fresh):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.active()
        with tracing.span("inside"):
            torch.ones(4).sum()
    assert not tracing.active()
    with tracing.span("after"):
        pass
    assert [s[0] for s in fresh.spans] == ["inside"]


def test_spans_nest_and_counters_become_step_records(monkeypatch):
    total = [0]
    monkeypatch.setitem(tracing.SOURCES, "test.source", lambda: total[0])
    lines = []
    t = tracing.Tracer(enabled=True, log=lines.append)
    timings = {}
    for step in range(2):
        with t.span(tracing.STEP):
            with t.span("a", timings, "a"):
                with t.span("b"):
                    t.add("n", 3)
                    total[0] += 5
            with t.timer("secs"):
                with t.timer("secs"):          # an inner call counts once
                    pass
    assert dict(t.counts) == {"step": 2, "step/a": 2, "step/a/b": 2}
    assert [n for n, _, _ in t.spans] == ["b", "a", "step"] * 2
    assert len(timings["a"]) == 2 and len(lines) == 6
    assert len(t.steps) == 2
    for (s0, s1, d), (_, a0, a1) in zip(t.steps, t.spans[2::3]):
        assert (s0, s1) == (a0, a1)
        assert d["n"] == 3 and d["test.source"] == 5
        assert 0 <= d["secs"] < s1 - s0
    # a span opened inside another of its parent's closes first
    for (_, b0, b1), (_, a0, a1) in zip(t.spans[0::3], t.spans[1::3]):
        assert a0 <= b0 <= b1 <= a1
    assert "counters (totals):" in t.summary()


def _sequence(t):
    """A fixed absorb/sample sequence over every transcript method."""
    t.absorb_slice([[(i * 7 + j) % 97 for j in range(24)] for i in range(5)])
    out = [t.get_challenge()]
    t.absorb_u64(3)
    out.append(t.squeeze_bytes(20))
    out.append(t.get_short_challenge())
    state, pending = t.export_for_device()
    t.import_from_device(state, pending)
    t.absorb_fq3((1, 2, p2.P - 1))
    t.absorb_ring(list(range(24)))
    out.append(t.get_challenge())
    t.absorb_slice([[5] * 24] * 11)
    out.append(t.get_challenge())
    return out


@pytest.mark.parametrize("challenger", ["native", "python"])
def test_transcript_perms_equal_the_duplex_challengers(fresh, monkeypatch,
                                                       challenger):
    if challenger == "native" and not native.available():
        pytest.skip("no native Poseidon2 core (no C++ compiler)")
    ran = [0]
    perm16 = p2.perm16

    def counted(state, record=False):
        ran[0] += 1
        return perm16(state, record)

    monkeypatch.setattr(p2, "perm16", counted)
    ref = Transcript()
    ref.ch = p2.DuplexChallenger()
    want = _sequence(ref)
    perms = ran[0]
    assert perms > 20

    fresh.enabled = True
    t = Transcript()
    if challenger == "python":
        t.ch = p2.DuplexChallenger()
    else:
        assert isinstance(t.ch, native.NativeChallenger)
    assert _sequence(t) == want
    assert fresh.counters[native.PERMS] == perms
    assert fresh.counters["transcript.s"] > 0
    if challenger == "native":
        assert 0 < fresh.counters[native.TIMER] <= \
            fresh.counters["transcript.s"]


def _wrapper_modules():
    from latticeum_tpu_torch.crypto import challenger, poseidon2  # noqa
    from latticeum_tpu_torch.field import mxu  # noqa
    from latticeum_tpu_torch.ring import decompose, rq  # noqa
    from latticeum_tpu_torch.zkvm import (accel, accel_nifs, comb,  # noqa
                                          tables)


def test_launch_registry_covers_every_entry_point():
    _wrapper_modules()
    entries = [e for _, es, _ in kernels.COUNTED for e in es]
    assert set(entries) == set(kernels.SIGNATURES)
    assert set(kernels.DEVICE_KERNELS) == set(kernels.SIGNATURES)
    wrappers = [w for w, _, _ in kernels.COUNTED]
    assert len({id(w) for w in wrappers}) == len(wrappers)
    assert all(isinstance(w.launches, int) for w in wrappers)
    assert kernels.launch_count() == sum(
        w.launches * len(kernels.DEVICE_KERNELS[es[0]])
        for w, es, _ in kernels.COUNTED)
    assert tracing.SOURCES["kernel.launches"] is kernels.launch_count
    csrc = "\n".join(p.read_text() for p in sorted((PORT / "csrc").glob(
        "*.cu")))
    for name in {k for ks in kernels.DEVICE_KERNELS.values() for k in ks}:
        assert re.search(r"__global__[^;{]*?\b" + name + r"\s*\(", csrc), name


def test_every_launch_site_counts_its_launch():
    """Each call that names an entry point in the port's sources sits in a
    function that adds to some wrapper's `launches`."""
    seen = set()
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            calls = [a.value for c in ast.walk(fn) if isinstance(c, ast.Call)
                     for a in c.args[:1] if isinstance(a, ast.Constant)
                     and isinstance(a.value, str)
                     and a.value in kernels.SIGNATURES]
            if not calls:
                continue
            counts = any(isinstance(n, ast.AugAssign)
                         and isinstance(n.target, ast.Attribute)
                         and n.target.attr == "launches"
                         for n in ast.walk(fn))
            assert counts, (str(path.relative_to(ROOT)), fn.name, calls)
            seen.update(calls)
    assert seen == set(kernels.SIGNATURES)


# -- the prover's spans -------------------------------------------------------
LAYERS = ("step.memtree", "step.arithmetize", "step.commit_z", "step.fold",
          "nifs.lin", "nifs.dec_l", "nifs.dec_r", "nifs.fold",
          "step.collector", "step.state_comms")
TIMINGS = {"trees", "trees.code", "trees.page_copy", "trees.upload",
           "trees.sponge", "trees.levels", "trees.fetch", "arithmetize",
           "commit_z", "fold_total", "collector", "state_comms", "lin",
           "dec_l", "dec_r", "fold", "step_times"}


def _fake_rounds(transcript, nv, degree, rows):
    """A sum-check's traffic on the host transcript (its nv and degree,
    then a message and a challenge a round) with made-up messages, and
    zero final rows: what the prover's spans and the collector's replay see
    of it, without its CPU twins' cost."""
    transcript.absorb_u64(nv)
    transcript.absorb_u64(degree)
    proof, chals = [], []
    for r in range(nv):
        msg = [[(r + i) % 5] * 24 for i in range(degree + 1)]
        transcript.absorb_slice(msg)
        proof.append(msg)
        chals.append(transcript.get_challenge())
    return proof, chals, torch.zeros((rows, 24), dtype=torch.int64)


def _shape_true_stubs(mp):
    """Replace the fold step's costliest CPU twins (the two sum-checks,
    the claims' digit-plane products, the eq and COO tables, the CRT) by
    stand-ins of the same shapes: two CPU steps take about 20 s, not the
    17 minutes of the real twins (test_real_two_steps_give_..., slow),
    and every span, timer and counter of the prover runs as it does
    there."""
    from latticeum_tpu_torch.ring import rq
    from latticeum_tpu_torch.zkvm import accel_rounds, claims
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
    mp.setattr(accel_rounds, "run_lin_rounds_factored",
               lambda transcript, g_t, nv, degree, *a, **kw: _fake_rounds(
                   transcript, nv, degree, g_t.shape[0]))
    mp.setattr(accel_rounds, "run_fold_rounds_factored",
               lambda transcript, head, tail, nv, degree, *a, **kw:
               _fake_rounds(transcript, nv, degree, 5 + tail.shape[0]))
    mp.setattr(claims, "eval_fhat", lambda f_hat, eq: torch.zeros(
        f_hat.shape[:-1], dtype=torch.int64))
    mp.setattr(claims, "eval_claims", lambda eqT, z: torch.zeros(
        (z.shape[0], eqT.shape[0], 24), dtype=torch.int64))
    mp.setattr(TorchNifs, "eqT", lambda self, point: torch.zeros(
        (self.ccs.t, 1, 24), dtype=torch.int64))
    mp.setattr(TorchNifs, "lin_g_t", lambda self, z, beta_s: torch.zeros(
        (self.ccs.t + 1, 1, 1), dtype=torch.int64))
    mp.setattr(TorchNifs, "_build_head", lambda self, *a: torch.zeros(
        (5, 1, 1), dtype=torch.int64))
    mp.setattr(rq, "crt", lambda x: x.clone())
    mp.setattr(rq, "icrt", lambda x: x.clone())


def _prove_two_steps(tmp_dir, stubbed):
    """Two CPU prove_vm steps at small parameters, traced, a checkpoint
    after the second: (prover, tracer)."""
    from latticeum_tpu_torch.host.vm.assembler import fib_const_guest
    from latticeum_tpu_torch.host.vm.vm import new_vm_1mb
    from latticeum_tpu_torch.host.zkvm.params import resolve
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver
    with pytest.MonkeyPatch.context() as mp:
        if stubbed:
            _shape_true_stubs(mp)
        mp.setattr(tracing, "GLOBAL", tracing.Tracer(enabled=True))
        prover = TorchZkVmProver(resolve(B=1 << 16, L=4, B_SMALL=4, K=8,
                                         KAPPA=8), device="cpu")
        vm = new_vm_1mb().load_elf_data(fib_const_guest(0xC594BFC3))
        prover.prove_vm(vm, max_steps=2, checkpoint_every=2,
                        checkpoint_dir=str(tmp_dir))
        return prover, tracing.GLOBAL


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    return _prove_two_steps(tmp_path_factory.mktemp("ck"), stubbed=True)


def _check_records_and_spans(tr):
    assert len(tr.steps) == 2
    steps = [(a, b) for n, a, b in tr.spans if n == tracing.STEP]
    assert steps == [(a, b) for a, b, _ in tr.steps]
    for a, b in steps:
        inside = [n for n, s, e in tr.spans if a <= s and e <= b]
        for name in LAYERS:
            assert inside.count(name) == 1, (name, inside)
        assert inside.count("nifs.dec.compute_x_s") == 2
    assert [n for n, _, _ in tr.spans].count("step.checkpoint") == 1
    for _, _, d in tr.steps:
        assert d["transcript.perms"] > 1000 and d["transcript.s"] > 0
        assert d["kernel.launches"] == 0          # the CPU twins launch none
        assert d.get("fetch.count", 0) == 0       # nor copy from a card
    assert tr.counts["step/step.fold/nifs.dec_l/nifs.dec.compute_x_s"] == 2


def _check_timings(prover):
    assert set(prover.timings) == TIMINGS | {"memtree"}
    for key in TIMINGS - {"trees", "trees.code", "trees.page_copy",
                          "trees.upload", "trees.sponge", "trees.levels",
                          "trees.fetch"}:
        assert len(prover.timings[key]) == 2, key
    assert len(prover.timings["memtree"]) == 2


def test_two_steps_give_a_record_and_each_layer_span_a_step(proved):
    _check_records_and_spans(proved[1])


def test_prover_timings_keep_their_keys(proved):
    _check_timings(proved[0])


@pytest.mark.slow
def test_real_two_steps_give_a_record_and_each_layer_span_a_step(tmp_path):
    """The same on the real CPU twins, about 17 minutes (the fold's
    sum-check twins most of it)."""
    prover, tr = _prove_two_steps(tmp_path, stubbed=False)
    _check_records_and_spans(tr)
    _check_timings(prover)


# -- the benchmark's readers --------------------------------------------------
def _window(tr, monkeypatch):
    """Steps 2 and 3 of four, t in [10, 20] s; the profiler's clock 1e6
    us ahead of the program's (window [11e6, 21e6] us)."""
    monkeypatch.setattr(tracing, "GLOBAL", tr)
    device = [("void fold_roundr_kernel<4>(unsigned long const*)", 12.0e6,
               12.5e6),
              ("reduce_partials_kernel(unsigned long const*)", 12.5e6,
               12.6e6),
              ("Memcpy DtoH (Device -> Pageable)", 16.0e6, 16.2e6),
              ("void fold_roundr_kernel<4>(unsigned long const*)", 25e6,
               25.1e6)]
    trace = Trace(device, [], (11e6, 21e6))
    return harness.Window(2, 10.0, 20.0, None, {}, trace)


def _recorded():
    tr = tracing.Tracer(enabled=False)
    tr.spans += [("step.arithmetize", 1.0, 2.0),          # before the window
                 ("step.arithmetize", 10.5, 11.0),
                 ("nifs.fold", 11.0, 14.0),
                 ("step.arithmetize", 15.0, 16.0),
                 ("step.checkpoint", 16.0, 18.0),
                 (tracing.STEP, 10.0, 15.0), (tracing.STEP, 15.0, 20.0)]
    tr.steps += [(1.0, 9.0, {"transcript.perms": 100}),
                 (10.0, 15.0, {"transcript.perms": 7, "kernel.launches": 2,
                               "transcript.s": 0.25}),
                 (15.0, 20.0, {"transcript.perms": 9, "kernel.launches": 0,
                               "transcript.s": 0.75})]
    return tr


def test_readers_read_a_hand_made_window(monkeypatch):
    w = _window(_recorded(), monkeypatch)
    read = {m: harness.reader(m).read(w) for m in (
        "prog.arith_s", "prog.ckpt_s", "prog.transcript.perms",
        "prog.launches", "prog.transcript_s", "prog.fetches",
        "prog.memtree_s", "prog.idle_unspanned_pct")}
    assert read["prog.arith_s"] == pytest.approx(0.75)
    assert read["prog.ckpt_s"] == pytest.approx(1.0)
    assert read["prog.transcript.perms"] == 8.0
    assert read["prog.launches"] == 1.0
    assert read["prog.transcript_s"] == pytest.approx(0.5)
    assert read["prog.fetches"] is None and read["prog.memtree_s"] is None
    # busy [12, 12.6] and [16, 16.2] (x 1e6 us); the layer spans map to
    # [11.5, 15] and [16, 19] (x 1e6 us): idle 9.2, of it 0.5 + 1.0 + 2.0
    # unspanned
    assert read["prog.idle_unspanned_pct"] == pytest.approx(
        100 * 3.5 / 9.2)
    assert progtrace.anchor_drift_us(w) == pytest.approx(0.0)
    assert progtrace.device_launches(w, ["fold_roundr_kernel"]) == {
        "fold_roundr_kernel": 1}
    assert progtrace.launches_outside(w, ["fold_roundr_kernel"],
                                      "nifs.fold") == (0, 1)
    assert progtrace.device_copies(w) == {
        "Memcpy DtoH (Device -> Pageable)": 1}


class _OldTracer:
    """A tracer as a checkout before the program's spans had it."""
    totals, counts = {}, {}


@pytest.mark.parametrize("metric", [
    "prog.arith_s", "prog.dec.x_s_s", "prog.transcript_s",
    "prog.transcript.native_s", "prog.transcript.perms", "prog.statecomm_s",
    "prog.launches", "prog.fetches", "prog.memtree_s", "prog.ckpt_s",
    "prog.idle_unspanned_pct"])
def test_readers_read_none_without_the_tracer(monkeypatch, metric):
    w = _window(_recorded(), monkeypatch)
    monkeypatch.setattr(tracing, "GLOBAL", _OldTracer())
    assert harness.reader(metric).read(w) is None
    monkeypatch.setattr(tracing, "GLOBAL", tracing.Tracer(enabled=False))
    assert harness.reader(metric).read(w) is None
