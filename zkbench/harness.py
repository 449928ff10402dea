"""One run of one cell: set up the prover, fold the window's steps of one
IVC chain in a closed loop, judge what they produced, print the result.

A cell `<config>.<mix>` of BENCHMARK.json names its files: the
configuration `configs/<config>.json` (the deployment: parameters, VM,
guest, Ajtai scheme, guarantees), the mix `traffic/<mix>.json` (the
guest's arguments, the heap it starts with, the warm-up, the steps
checked), and each per-layer metric `metrics/<metric>.py` (a reader, and
the program's functions its spans wrap).  Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import check, spans as spans_mod
from .devtrace import WINDOW, Trace
from .ref.vm import assembler

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "latticeum_tpu")
GUESTS = {"fib_loop": assembler.fib_loop_guest,
          "fib_const": assembler.fib_const_guest,
          "mem_churn": assembler.mem_churn_guest,
          "xorshift": assembler.xorshift_guest}


class Refused(Exception):
    """The run cannot be made here (no card, a cell not in the
    manifest, a configuration the harness cannot build): exit without a
    result."""


# a configuration's Ajtai scheme kind -> the prover's keyword arguments
# (the reference builds the same kind: check.SCHEMES)
SCHEMES = {"row_constant": {}, "general": {"general_ajtai": True}}


# -- what a cell is made of ------------------------------------------------
def manifest():
    return json.loads(MANIFEST.read_text())


def cell_files(name, bench=None):
    """(workload entry, configuration, mix, [(metric entry, reader)]) of
    cell `name`."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in {MANIFEST.name}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    metrics = [(m, reader(m["name"])) for m in bench["per_layer"]
               if name in m.get("workloads", [name] if m["moves"] in e2e
                                else [])]
    return w, config, mix, metrics


def scheme(config):
    """(kind, the prover's keyword arguments) of the configuration's Ajtai
    scheme `{"kind": ..., "seed": "--seed"}`.  A kind missing or unknown,
    or a seed other than the run's, is refused: no scheme is assumed."""
    sch = config.get("scheme") or {}
    kind = sch.get("kind")
    if kind not in SCHEMES:
        raise Refused(f"configuration {config.get('name')!r}: Ajtai scheme "
                      f"kind {kind!r} is not one of {sorted(SCHEMES)}")
    if sch.get("seed") != "--seed":
        raise Refused(f"configuration {config.get('name')!r}: Ajtai scheme "
                      f"seed {sch.get('seed')!r}, not \"--seed\"")
    return kind, dict(SCHEMES[kind])


def end_to_end(name, bench=None):
    """The names of the end-to-end metrics that cell `name` reports."""
    bench = bench or manifest()
    return [m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def reader(name):
    """The module of metric `name`, from metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "zkbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(config, mix, seed):
    """The guest, the VM's size and its starting heap, made from the seed:
    what the program and the reference are both given."""
    elf = GUESTS[config["guest"]](**mix.get("guest_args", {}))
    heap = []
    fill = mix.get("heap_fill")
    if fill:
        rng = np.random.default_rng([seed, 0])
        words = rng.integers(0, 1 << 32, fill["words"], dtype=np.uint64)
        heap = [(fill["base"] + 4 * i, int(v)) for i, v in enumerate(words)]
    return {"elf": elf, "heap": heap,
            "words_per_page": config["vm"]["words_per_page"],
            "page_count": config["vm"]["page_count"]}


# -- the window ---------------------------------------------------------
class Window:
    """What a per-layer reader sees of the traced run."""

    def __init__(self, steps, t0, t1, spans, timings, trace):
        self.steps, self.t0, self.t1 = steps, t0, t1
        self.spans, self.timings, self.trace = spans, timings, trace

    def span_per_step(self, name):
        """Seconds a step inside span `name`; None if it never ran."""
        if not any(n == name for n, _, _ in self.spans.closed):
            return None
        return self.spans.total(name, self.t0, self.t1) / self.steps

    def timing_per_step(self, *keys):
        """The program's marks `keys`, summed over the window's steps, a
        step; None if one is missing."""
        if any(k not in self.timings for k in keys):
            return None
        return sum(sum(self.timings[k]) for k in keys) / self.steps


class Closed:
    """The window of a closed loop: it opens when the last warm-up step
    ends and closes when the first step ends `seconds` or more after it
    opened.  `step_s` is all its time over all its steps."""

    def __init__(self, warm, seconds, clock=time.perf_counter):
        self.warm, self.seconds, self.clock = warm, seconds, clock
        self.t0 = self.t1 = None
        self.steps = 0

    def after(self, step):
        """Called as step `step` ends: "open", "close" or None."""
        if step == self.warm:
            self.t0 = self.clock()
            return "open"
        if step > self.warm and self.t1 is None:
            self.steps += 1
            if self.clock() - self.t0 >= self.seconds:
                self.t1 = self.clock()
                return "close"
        return None

    @property
    def step_s(self):
        return (self.t1 - self.t0) / self.steps


class Sample:
    """Which window steps the reference judges: a reservoir of `k` drawn
    from the seed over all the window's steps, so every step of the
    window is as likely to be judged, however many it holds."""

    def __init__(self, k, seed):
        self.k, self.rng = k, np.random.default_rng([seed, 1])
        self.slots, self.seen = [], 0

    def offer(self, step):
        """Whether `step` enters; the step it displaces goes out."""
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append(step)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.slots[j] = step
            return True
        return False


def host_u64(t):
    """A card tensor of u64 bits in int64 -> a numpy uint64 array."""
    return t.detach().cpu().numpy().view(np.uint64)


def snapshot(step, state):
    """The program's public state after `step`: references only (each
    fold makes new objects), converted after the window."""
    return {"step": step, "acc": state.acc, "fvars":
            state.folding_proof_vars, "z_0_comm": state.z_0_comm,
            "z_i_comm": state.z_i_comm, "acc_comm": state.acc_comm,
            "ivc_step_comm": state.ivc_step_comm, "proof":
            state.folding_proof}


def to_reference(rec):
    out = dict(rec)
    out["acc"] = check.lcccs(rec["acc"])
    for k in ("z_0_comm", "z_i_comm", "acc_comm"):
        out[k] = [int(v) for v in rec[k]]
    out["ivc_step_comm"] = check.plain(list(rec["ivc_step_comm"]))
    if "cm_i" in rec:
        out["cm_i"] = check.CCCS(cm=[list(c) for c in rec["cm_i"].cm],
                                 x_ccs=[list(x) for x in rec["cm_i"].x_ccs])
    return out


# -- faults, for the control and the tests ----------------------------------
def install_fault(fault, undo):
    """Break the timed path underneath the harness (`undo` collects what
    restores it).  "partial_transcript" is the control: the program's
    transcript binds only the first ring of each absorbed slice, so the
    fold's challenges no longer depend on the whole proof.
    "unchanged": each fold returns the accumulator it was given.
    "altered": one coefficient of each folded witness is changed where
    the fold produces it."""
    from latticeum_tpu_torch.host.crypto.transcript import Transcript
    from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs
    if fault == "partial_transcript":
        orig = Transcript.absorb_slice

        def absorb_slice(self, rings):
            return orig(self, list(rings)[:1])
        Transcript.absorb_slice = absorb_slice
        undo.append(lambda: setattr(Transcript, "absorb_slice", orig))
    elif fault in ("unchanged", "altered"):
        orig = TorchNifs.prove

        def prove(self, acc, w_acc, cm_i, w_i, transcript, **kw):
            folded, w0, proof = orig(self, acc, w_acc, cm_i, w_i,
                                     transcript, **kw)
            if fault == "unchanged":
                return acc, w_acc, proof
            w0.f_coeff[0, 0] += 1
            return folded, w0, proof
        TorchNifs.prove = prove
        undo.append(lambda: setattr(TorchNifs, "prove", orig))
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


# -- one run --------------------------------------------------------------
def run(name, seed, seconds, trace, t_start, fault=None, log=None):
    """Run cell `name` once on the card.  Returns (the result, the
    mismatches by kind, the window's trace or None)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    w, config, mix, metrics = cell_files(name)
    kind, scheme_kw = scheme(config)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        raise Refused(f"{name} needs {w['chips']} CUDA device(s); "
                      f"found {torch.cuda.device_count()}")
    from latticeum_tpu_torch import kernels
    from latticeum_tpu_torch.host.vm.vm import VM
    from latticeum_tpu_torch.host.zkvm.params import resolve
    from latticeum_tpu_torch.zkvm.prover import TorchZkVmProver

    data = inputs(config, mix, seed)
    params = resolve(**config["params"])
    every = config.get("checkpoint_every")
    undo = []
    spans = spans_mod.Spans(ranges=bool(trace))
    with contextlib.ExitStack() as stack:
        # at exit the wrappers come off in the reverse of their order on
        stack.callback(spans.uninstall)
        stack.callback(lambda: [u() for u in reversed(undo)])
        range_names = set()
        if trace:
            for _, mod in metrics:
                for span, targets in getattr(mod, "TARGETS", {}).items():
                    if spans.install(span, targets):
                        range_names.add(span)
        install_fault(fault, undo)
        ckdir = stack.enter_context(tempfile.TemporaryDirectory(
            prefix="zkbench_ckpt_")) if every else None
        t = time.perf_counter()
        kernels.lib()
        log(f"kernels ready in {time.perf_counter() - t:.3f} s "
            f"(built: {kernels.build_info.get('seconds')})")
        t = time.perf_counter()
        prover = TorchZkVmProver(params, scheme_seed=seed, device="cuda",
                                 **scheme_kw)
        log(f"prover built in {time.perf_counter() - t:.3f} s ({kind} "
            f"Ajtai scheme, {scheme_kw})")
        vm = VM(data["words_per_page"], data["page_count"])
        vm.load_elf_data(data["elf"])
        for addr, word in data["heap"]:
            vm.write_mem(addr, word)

        sample = Sample(mix["checked_steps"], seed)
        win = Closed(mix["warmup_steps"], seconds)
        st = {"records": {}, "ckpt": None, "prev": None, "pending": {}}

        orig_init = TorchZkVmProver.initialize_accumulator

        def initialize_accumulator(self, *args, **kwargs):
            """The program's; its accumulator and witness are kept for the
            reference (the chain's start)."""
            acc, wit = orig_init(self, *args, **kwargs)
            st["start"] = (acc, host_u64(wit.f_coeff))
            return acc, wit
        TorchZkVmProver.initialize_accumulator = initialize_accumulator
        undo.append(lambda: setattr(TorchZkVmProver, "initialize_accumulator",
                                    orig_init))

        orig_commit = TorchZkVmProver.commit_z

        def commit_z(self, z_rings):
            """The program's commit_z; for a step the reference will judge,
            its CCCS and a host copy of its witness are kept."""
            cm_i, w_i = orig_commit(self, z_rings)
            step = st["prev"]["step"] + 1 if st["prev"] else 1
            if win.t0 is not None and (sample.offer(step) or (
                    every and step % every == 0)):
                st["pending"] = {"cm_i": cm_i, "w_ccs": host_u64(w_i.w_ccs)}
            return cm_i, w_i
        TorchZkVmProver.commit_z = commit_z
        undo.append(lambda: setattr(TorchZkVmProver, "commit_z",
                                    orig_commit))

        def on_step(step, state):
            rec = snapshot(step, state)
            pending, st["pending"] = st["pending"], {}
            if pending:
                rec.update(pending)
                rec["f_coeff"] = host_u64(state.w_acc.f_coeff)
                st["records"][step - 1] = st["prev"]
                st["records"][step] = rec
                if every and step % every == 0:
                    st["ckpt"] = (step, os.path.join(
                        ckdir, f"ivc_step_{step}.npz"))
                keep = set(sample.slots) | {st["ckpt"][0]} if st["ckpt"] \
                    else set(sample.slots)
                st["records"] = {j: r for j, r in st["records"].items()
                                 if j in keep or j + 1 in keep}
            st["prev"] = rec
            torch.cuda.synchronize()
            if step == win.warm:
                st["cpu"] = (time.process_time(), os.getloadavg()[0])
                torch.cuda.reset_peak_memory_stats()
                st["marks"] = {k: len(v) for k, v in prover.timings.items()}
                if trace:
                    st["prof"] = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    st["prof"].__enter__()
                    st["range"] = torch.profiler.record_function(WINDOW)
                    st["range"].__enter__()
            if win.after(step) == "close":
                st["cpu"] = (time.process_time() - st["cpu"][0],
                             st["cpu"][1], os.getloadavg()[0])
                if trace:
                    st["range"].__exit__(None, None, None)
                st["peak"] = (torch.cuda.memory_stats()[
                    "requested_bytes.all.peak"],
                    torch.cuda.max_memory_allocated())
                raise StopIteration

        log(f"set-up before prove_vm: {time.perf_counter() - t_start:.3f} s")
        prover.prove_vm(vm, on_step=on_step, checkpoint_dir=ckdir,
                        checkpoint_every=every or 10)
        if win.t1 is None:
            raise RuntimeError(f"the guest ended after {win.steps} window "
                               "steps, before the window closed")
        n = win.steps
        timings = {k: v[st["marks"].get(k, 0):]
                   for k, v in prover.timings.items()}
        tr = None
        if trace:
            st["prof"].__exit__(None, None, None)
            tr = Trace.read(st.pop("prof"), range_names)
        ck = st["ckpt"]
        log(f"window: {n} steps in {win.t1 - win.t0:.3f} s; set-up "
            f"{win.t0 - t_start:.3f} s; checked steps {sorted(sample.slots)}"
            "; last checkpoint "
            + (f"step {ck[0]}, {os.path.getsize(ck[1])} bytes, of "
               f"{len(os.listdir(ckdir))} written" if ck else "none"))
        log("window: process CPU seconds {:.3f}, load average {:.2f} at its "
            "start, {:.2f} at its end".format(*st["cpu"]))
        log("window step seconds (the program's step_times): " + " ".join(
            f"{x:.3f}" for x in timings.get("step_times", [])))
        if spans.missing:
            log(f"targets not found: {spans.missing}")

        if trace:
            seen = Window(n, win.t0, win.t1, spans, timings, tr)
            metrics_out = {}
            for m, mod in metrics:
                v = mod.read(seen)
                if v is not None:
                    metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            measured = {
                "step_s": {"value": win.step_s, "unit": "s/step"},
                "peak_mem_gib": {"value": st["peak"][0] / 2**30,
                                 "unit": "GiB"},
                "setup_s": {"value": win.t0 - t_start, "unit": "s"}}
            metrics_out = {k: measured[k] for k in end_to_end(name)}
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": w["chips"], "memory_peak_bytes": st["peak"][1]}
        if trace:
            device["busy_s"] = tr.busy_s()
            device["window_s"] = tr.window_s()

        # the program's state goes before the reference runs
        checked = set(sample.slots) | ({ck[0]} if ck else set())
        records = {j: to_reference(st["records"][j])
                   for i in checked for j in (i - 1, i)}
        start = (check.lcccs(st["start"][0]), st["start"][1])
        del prover, st, vm, on_step, commit_z, initialize_accumulator
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = check.Reference(params, seed, kind)
        log(f"reference built in {time.perf_counter() - t:.3f} s")
        bad, secs, failed = check.judge(ref, data, records, checked, ck,
                                        start)
        log("reference seconds: " + json.dumps(
            {k: round(v, 3) for k, v in secs.items()}))

    result = {"correct": not any(bad.values()), "attempted": n,
              "failed": len(failed),
              "metrics": metrics_out, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.gaps_by_span()}
    return result, bad, tr
