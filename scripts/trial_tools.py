"""What the kernel design-trial scripts (``scripts/*_trials.py``) share:
compiling copies of a CUDA source, each by its own nvcc and all at once;
reading ptxas's registers and spills; timing by CUDA events and by CUDA
graphs; the card's name and power limit; and the ctypes signatures of
another checkout's kernels.  Runs on a machine with a card and the CUDA
toolkit; importing it builds and launches nothing.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path

import torch

from latticeum_tpu_torch import kernels


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(sources, out_dir):
    """{name: (library, ptxas output)}: each source of `sources` ({name:
    (path of a .cu file, extra nvcc flags)}) compiled into a shared
    library of its own under `out_dir`, each by its own nvcc, all at once.
    Raises with the compiler's output if one fails."""
    flags = [*kernels.ARCH_FLAGS, "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-shared"]
    procs = {}
    for name, (src, extra) in sources.items():
        so = Path(out_dir) / f"lib{len(procs)}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc(), *flags, *extra, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        out[name] = (ctypes.CDLL(str(so)), text)
    return out


def ptxas(text, kernel=""):
    """[(entry function, registers, spill-store bytes)] from ptxas -v
    output, for the entry functions whose mangled names hold `kernel`."""
    found, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            spill = 0
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.append((fn, int(m.group(1)), spill))
            fn = None
    return found


def events_ms(fn, reps=20):
    """Mean ms of `reps` back-to-back calls of fn, by CUDA events, after
    one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=3):
    """Device ms per call of fn: `reps` calls captured in a CUDA graph,
    replayed once to warm up, then `replays` times by CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return events_ms(g.replay, replays) / reps


def signatures(checkout):
    """``kernels.SIGNATURES`` of the checkout at `checkout` (its
    ``latticeum_tpu_torch/kernels.py``, which imports only the standard
    library and torch)."""
    path = Path(checkout) / "latticeum_tpu_torch" / "kernels.py"
    spec = importlib.util.spec_from_file_location("checkout_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES
