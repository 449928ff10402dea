"""Build fold_c_round's kernel in design variants and time each at the
fold's round widths, on a machine with a card and the CUDA toolkit:

    python3 scripts/fold_c_trials.py [--parent DIR]

Each variant is a copy of ``latticeum_tpu_torch/csrc/comb.cu`` with some of
its constants rewritten (``FC_CLUSTER``, ``FC_STAGES``, ``FC_TW``: the
cluster size, the stages of the tile ring, the threads a block; or the TMA
path never chosen, so that every tile goes by cp.async) and a probe entry
point ``lt_fold_c_clusters`` appended (how many of the kernel's clusters
the card holds at once).  Every copy is compiled by its own nvcc, all at
once, each into a library of its own under a fresh directory of
``_build/``.  With ``--parent DIR``, the ``latticeum_tpu_torch/csrc/
comb.cu`` of the checkout at DIR is built too, as it is, and timed beside
them (a tree whose ``lt_fold_c_round`` still takes the per-device ticket
and the partials buffer is called with them).  Each variant runs round 0
at m = 2^17 on a fold head's strided rows and the folded rounds at 2^16,
2^15 and 2^12, is held bit for bit against ``comb.fold_c_round_twin`` and
is timed by CUDA events (the mean of 20 back-to-back launches, twice, the
variants in turns).  Prints one JSON line: the card (``nvidia-smi`` name
and power limit) and, per variant, its rewrites, its ptxas registers, the
clusters the card holds at once (round 0, folded; this tree's variants)
and its times in ms by width; and, for grids of 16 clusters of 6, 7 and 8
blocks of 256 threads at the shared memory of round 0's and a folded
round's stage ring, the number of distinct SMs their blocks ran on
(``PLACEMENT_SRC``, each block spinning long enough that all are resident
together).  The directories are removed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from latticeum_tpu_torch import kernels  # noqa: E402
from latticeum_tpu_torch.field import goldilocks as gl  # noqa: E402
from latticeum_tpu_torch.zkvm import comb  # noqa: E402
import trial_tools  # noqa: E402
from trial_tools import events_ms  # noqa: E402

# A variant's rewrites of comb.cu: a constant's new value, or "bulk": False
# for the cp.async path on every tile.
VARIANTS = {
    "clusters of 6, TMA, 3 stages (the kernel)": {},
    "clusters of 6, cp.async": {"bulk": False},
    "clusters of 6, TMA, 2 stages": {"FC_STAGES": 2},
    "clusters of 6, TMA, 4 stages": {"FC_STAGES": 4},
    "clusters of 6, TMA, blocks of 512, 2 stages": {"FC_TW": 512,
                                                     "FC_STAGES": 2},
    "clusters of 7, TMA": {"FC_CLUSTER": 7},
    "clusters of 8, TMA": {"FC_CLUSTER": 8},
    "clusters of 8, cp.async": {"FC_CLUSTER": 8, "bulk": False},
}
# Appended to each variant: how many of fold_c_kernel's clusters (folded or
# not, TMA form) the card holds at once.
CLUSTERS_SRC = r"""
extern "C" int lt_fold_c_clusters(int fold, int *clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FC_CLUSTER, 16);
  cfg.blockDim = dim3(FC_TW);
  cfg.dynamicSmemBytes = fold ? fc_smem_bytes<true>() : fc_smem_bytes<false>();
  cudaError_t err = fold ? cudaFuncSetAttribute(
                               fold_c_kernel<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fc_smem_bytes<true>())
                         : cudaFuncSetAttribute(
                               fold_c_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fc_smem_bytes<false>());
  if (err != cudaSuccess) return (int)err;
  return (int)(fold ? cudaOccupancyMaxActiveClusters(
                          clusters, fold_c_kernel<true, true>, &cfg)
                    : cudaOccupancyMaxActiveClusters(
                          clusters, fold_c_kernel<false, true>, &cfg));
}
"""
# A grid of 16 clusters of CL blocks, each block recording its SM and
# spinning ~1 ms so that the whole grid is resident at once.
PLACEMENT_SRC = r"""
#include <cuda_runtime.h>
template <int CL>
__global__ void __cluster_dims__(CL, 1, 1) place_kernel(int *sm) {
  extern __shared__ char pad[];
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  const long long t0 = clock64();
  while (clock64() - t0 < 2000000) {
  }
  if (threadIdx.x == 0) {
    pad[0] = 1;
    sm[blockIdx.y * gridDim.x + blockIdx.x] = (int)id;
  }
}
template <int CL>
static int run(int *sm, int smem) {
  cudaFuncSetAttribute(place_kernel<CL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  place_kernel<CL><<<dim3(CL, 16), 256, smem>>>(sm);
  return (int)cudaDeviceSynchronize();
}
extern "C" int place(int cl, int *sm, int smem) {
  return cl == 6 ? run<6>(sm, smem) : cl == 7 ? run<7>(sm, smem)
                                              : run<8>(sm, smem);
}
"""
STAGE_BYTES = {"round 0": 3 * 18 * 256 * 8, "folded": 3 * 24 * 256 * 8}
M = 1 << 17
WIDTHS = ((M, False), (M // 2, True), (M // 4, True), (1 << 12, True))
_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def variant_source(text, rewrites):
    """comb.cu's text with the rewrites made and the cluster probe
    appended; raises if a rewrite finds nothing to change."""
    for name, value in rewrites.items():
        if name == "bulk":
            text, n = re.subn(r"const bool bulk =",
                              "const bool bulk = false &&", text)
        else:
            text, n = re.subn(rf"^#define {name} \d+",
                              f"#define {name} {value}", text, flags=re.M)
        if n != 1:
            raise RuntimeError(f"comb.cu: {n} places to rewrite {name}")
    return text + CLUSTERS_SRC


def build(out_dir, sources):
    """{name: (library, ptxas registers of fold_c_kernel)}, every source
    compiled by its own nvcc, all at once."""
    flags = ["-I", str(kernels.CSRC)]
    built = trial_tools.build(
        {name: (src, [*flags, *extra]) for name, (src, extra)
         in sources.items()}, out_dir)
    return {name: (lib, [r for _, r, _ in
                         trial_tools.ptxas(text, "fold_c_kernel")])
            for name, (lib, text) in built.items()}


def caller(lib, ticketed, args, w):
    """A function that launches lib's lt_fold_c_round once on args."""
    c2r, eqs, r3, c, Tn, sums = args
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = lib.lt_fold_c_round

    def p(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())
    head = [p(c2r), c2r.stride(0), p(eqs), eqs.stride(0), p(r3),
            None if r3 is None else p(c), p(Tn)]
    if ticketed:
        nbx = min(-(-(w // 2) // 128), 64)
        partial = torch.empty((8, nbx, 12), dtype=gl.DTYPE, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        fn.argtypes = [_VP, _I64] * 2 + [_VP] * 6 + [_I64, _VP]
        tail = [p(partial), p(ticket), p(sums), w, stream]
    else:
        fn.argtypes = [_VP, _I64] * 2 + [_VP] * 4 + [_I64, _VP]
        tail = [p(sums), w, stream]

    def run():
        err = fn(*head, *tail)
        if err:
            raise RuntimeError(f"lt_fold_c_round: cudaError {err}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fold_c_trials: no CUDA card")
    card = trial_tools.card()
    text = (kernels.CSRC / "comb.cu").read_text()
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    out_dir = kernels.BUILD_DIR / f"trials.{os.getpid()}"
    out_dir.mkdir()
    try:
        sources = {}
        for i, (name, rewrites) in enumerate(VARIANTS.items()):
            src = out_dir / f"comb{i}.cu"
            src.write_text(variant_source(text, rewrites))
            sources[name] = (src, [])
        ticketed = set()
        if args.parent:
            psrc = (Path(args.parent) / "latticeum_tpu_torch" / "csrc"
                    / "comb.cu")
            sources["parent"] = (psrc, ["-I", str(psrc.parent)])
            if "unsigned *ticket" in psrc.read_text():
                ticketed.add("parent")
        (out_dir / "place.cu").write_text(PLACEMENT_SRC)
        libs = build(out_dir, {**sources,
                               "place": (out_dir / "place.cu", [])})
        place = libs.pop("place")[0].place
        place.argtypes = [_I32, _VP, _I32]
        report = {"card": card, "variants": {}, "sms_of_16_clusters": {}}
        sm = torch.empty(16 * 8, dtype=torch.int32, device="cuda")
        for cl in (6, 7, 8):
            for label, smem in STAGE_BYTES.items():
                sm.fill_(-1)
                if place(cl, ctypes.c_void_p(sm.data_ptr()), smem):
                    raise RuntimeError("the placement probe failed")
                report["sms_of_16_clusters"][f"{cl} blocks, {label}"] = len(
                    set(sm[:16 * cl].tolist()))
        for name, (lib, regs) in libs.items():
            held = None
            if name in VARIANTS:
                held = []
                for fold in (0, 1):
                    n = ctypes.c_int(0)
                    lib.lt_fold_c_clusters.argtypes = [_I32, _VP]
                    lib.lt_fold_c_clusters(
                        fold, ctypes.c_void_p(ctypes.addressof(n)))
                    held.append(n.value)
            report["variants"][name] = {
                "rewrites": VARIANTS.get(name, {}),
                "registers": regs, "clusters_held": held, "ms": {}}
        rng = np.random.default_rng(41)

        def rnd(*shape):
            u = rng.integers(0, gl.P, shape, dtype=np.uint64)
            return torch.from_numpy(gl.to_i64_bits(u)).cuda()

        for w, fold in WIDTHS:
            head = rnd(5, 24, w)
            c2r = rnd(2, 24, 2 * w) if fold else head[1:4:2]
            r3 = rnd(3) if fold else None
            eqs = head[0::2]
            want = comb.fold_c_round_twin(c2r, eqs, r3)
            runs = {}
            for name, (lib, _) in libs.items():
                c = torch.empty((2, 24, w), dtype=gl.DTYPE, device="cuda") \
                    if fold else c2r
                Tn = torch.empty((3, 24, w // 2), dtype=gl.DTYPE,
                                 device="cuda")
                sums = torch.empty((4, 24), dtype=gl.DTYPE, device="cuda")
                run = caller(lib, name in ticketed,
                             (c2r, eqs, r3, c, Tn, sums), w)
                run()
                torch.cuda.synchronize()
                got = (c, Tn, sums)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name}: width {w} differs from the "
                                     "twin")
                runs[name] = run
            key = f"{w}{' folded' if fold else ''}"
            for _ in range(2):
                for name, run in runs.items():
                    report["variants"][name]["ms"].setdefault(
                        key, []).append(events_ms(run))
            del head, c2r, want, runs
        print(json.dumps(report), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
