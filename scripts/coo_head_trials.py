"""Build ``latticeum_tpu_torch/csrc/coo.cu`` in design variants, check each
launch of each for faults and against the twin, and time the fold head's
challenged-z kernel (coo_head) and the plain segment sums (coo_matvec) at
the production shape, on a machine with a card and the CUDA toolkit:

    python3 scripts/coo_head_trials.py [--parent DIR] [--sass DIR]

Each variant (``VARIANTS``) is a copy of coo.cu with some of its constants
rewritten (``HEAD_LANES``: the entry runs of a head block, 8 threads each;
``HEAD_GROUP``: the witnesses whose z a thread loads together, one group
ahead; ``HEAD_MIN_BLOCKS``: the head blocks an SM that
``__launch_bounds__`` asks the registers to allow) or some of its lines
replaced: for timing only (the head without its z loads, or without its
products: their sums are wrong), or another form of coo_kernel's entry
loop (exact).  Every copy is compiled by its own nvcc, all at once
(``trial_tools.build``).  With ``--parent DIR``, the coo.cu of the checkout
at DIR is built too, as it is, called through that checkout's
``kernels.SIGNATURES``; where its ``lt_coo_matvec`` still has the head
mode (it takes zeta), that mode is timed beside the head, one launch a c
row.

First every variant runs the head on ragged maps of one block of segments
(a 705-entry segment, segments of 1 ... 20 entries, three segments, all
inputs p - 1; 1, 3 and 15 witnesses a row) and on the production head map,
with a synchronize after every launch, so that a launch that faults is
named; the exact variants are held bit for bit against
``accel.coo_head_twin``.  Then, at the production head map (67,990
entries, 10,361 non-empty of 2^17 bit-reversed rows, t = 125, 2K = 30
witnesses), with the CCS's scalar values and with random ring values, each
variant's head is timed by CUDA events (the mean of 20 back-to-back
launches, twice, the variants in turns) and by a CUDA graph of 20 launches.
Last, with ``--parent``, the plain modes (the M z and M^T eq maps, scalar
and ring values) of this tree, of the variants that rewrite coo_kernel and
of the parent, each held against the twin and timed by a CUDA graph of
20, in turns (parent, change, change, parent).  With ``--sass DIR``, each
library's SASS (``cuobjdump -sass``) is written there.  Prints one JSON
line: the card (``nvidia-smi`` name and power limit), per variant its
rewrites, ptxas registers and spills and its times in ms by kind, and the
plain modes' graph times.  The directories are removed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from latticeum_tpu_torch import kernels  # noqa: E402
from latticeum_tpu_torch.field import goldilocks as gl  # noqa: E402
from latticeum_tpu_torch.zkvm import accel, tables  # noqa: E402
import trial_tools  # noqa: E402
from trial_tools import events_ms, graph_ms  # noqa: E402

# coo_kernel's entry loop, and the same loop as one the compiler counts
# and unrolls by 4.
GUARDED_LOOP = """#pragma unroll 1
  for (int e = e0 + lane; e < e1; e += 4 * L) {
    entry<RING>(a, e, slot, acc);
#pragma unroll
    for (int u = 1; u < 4; ++u)
      if (e + u * L < e1) entry<RING>(a, e + u * L, slot, acc);
  }"""
COUNTED_LOOP = """#pragma unroll 4
  for (int e = e0 + lane; e < e1; e += L) entry<RING>(a, e, slot, acc);"""

# A variant: "defines", coo.cu's constants rewritten; "lines", (old, new)
# texts each found once; "exact", whether it still computes the sums;
# "plain", whether it rewrites coo_kernel (timed in the plain modes).
VARIANTS = {
    "48 runs a block, groups of 5 (the kernel)": {},
    "48 runs, groups of 3": {"defines": {"HEAD_GROUP": 3}},
    "48 runs, groups of 4": {"defines": {"HEAD_GROUP": 4}},
    "64 runs, groups of 3": {"defines": {"HEAD_LANES": 64,
                                         "HEAD_GROUP": 3}},
    "32 runs, groups of 5": {"defines": {"HEAD_LANES": 32}},
    "48 runs, groups of 5, 2 blocks an SM": {
        "defines": {"HEAD_MIN_BLOCKS": 2}},
    # Timing only: the head without its z loads (each word made from the
    # pointer), and without its products (the z words xor-ed into y).
    "no z loads": {"exact": False, "lines": [(
        "buf[j] = Fq3{zr[0], zr[1], zr[2]};",
        "buf[j] = Fq3{(u64)zr, (u64)zr ^ 1ULL, (u64)zr ^ 2ULL};")]},
    "no products": {"exact": False, "lines": [(
        "fq3_mac_w(y, zc[0], zc[1], zc[2], zc[3], zc[4], cur[j]);",
        "{ y[0].lo ^= cur[j].c0 ^ zc[0]; y[1].lo ^= cur[j].c1 ^ zc[3];"
        " y[2].lo ^= cur[j].c2 ^ zc[4]; }")]},
    "plain modes, counted loop": {"plain": True,
                                  "lines": [(GUARDED_LOOP, COUNTED_LOOP)]},
}


def variant_source(text, spec):
    """coo.cu's text with a variant's rewrites made; raises unless each
    finds its text exactly once."""
    for key, value in spec.get("defines", {}).items():
        text, n = re.subn(rf"^#define {key} \d+", f"#define {key} {value}",
                          text, flags=re.M)
        if n != 1:
            raise RuntimeError(f"coo.cu: {n} places to rewrite {key}")
    for old, new in spec.get("lines", ()):
        n = text.count(old)
        if n != 1:
            raise RuntimeError(f"coo.cu: {n} places to rewrite "
                               f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    return text


def ragged_maps(rng, dev):
    """(name, csr, zs, zeta, outs) on ragged head maps of one block."""
    cases = [("705-entry segment, 15 witnesses", 1024, 705, 15, False),
             ("705-entry segment, rings, 1 witness", 1024, 705, 1, True),
             ("3 witnesses", 4096, 90, 3, False),
             ("three segments", 64, 0, 15, True),
             ("all p - 1", 512, 200, 15, False)]
    out = []
    for name, nseg, heavy, k, ring in cases:
        t, rows_in = 7, 300
        if heavy:
            seg = np.concatenate([rng.integers(0, nseg, nseg // 4),
                                  np.full(heavy, nseg // 2),
                                  np.repeat(np.arange(5, 25),
                                            np.arange(1, 21))])
        else:
            seg = np.array([0, nseg // 3, nseg // 3, nseg - 1])
        nnz = seg.shape[0]
        v = rng.integers(0, gl.P, (nnz, 24) if ring else (nnz,),
                         dtype=np.uint64)
        zs = rng.integers(0, gl.P, (2 * k, rows_in, 24), dtype=np.uint64)
        zeta = rng.integers(0, gl.P, (2 * k, t, 3), dtype=np.uint64)
        if name == "all p - 1":
            for a in (v, zs, zeta):
                a[...] = gl.P - 1
        csr = accel.build_csr(seg, rng.integers(0, rows_in, nnz),
                              rng.integers(0, t, nnz), v, nseg, nseg, dev,
                              head=True)

        def put(a):
            return torch.from_numpy(gl.to_i64_bits(a)).to(dev)
        outs = put(rng.integers(0, gl.P, (2, 24, nseg), dtype=np.uint64))
        out.append((name, csr, put(zs), put(zeta), outs))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout, timed beside")
    ap.add_argument("--sass", help="write each library's SASS (cuobjdump) "
                    "into this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from latticeum_tpu_torch.host.zkvm.builder import create_riscv_ccs
    from latticeum_tpu_torch.host.zkvm.layout import CCSLayout
    from latticeum_tpu_torch.host.zkvm.params import default_params
    params = default_params()
    ccs = create_riscv_ccs(CCSLayout(params))
    K, n, m, t = params.K, ccs.n, ccs.m, ccs.t
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def rnd(*shape):
        u = rng.integers(0, gl.P, shape, dtype=np.uint64)
        u.reshape(-1)[:48] = gl.P - 1
        return torch.from_numpy(gl.to_i64_bits(u)).to(dev)

    rows, cols, mats, vals, _ = accel._coo_host(ccs)
    brev = tables.brev_host(m).numpy()
    ring_vals = rng.integers(0, gl.P, (vals.shape[0], 24), dtype=np.uint64)
    csrs = {kind: accel.build_csr(brev[rows], cols, mats, v, m, m, dev,
                                  head=True)
            for kind, v in (("scalar", vals), ("ring", ring_vals))}
    zs, zeta, base = rnd(2 * K, n, 24), rnd(2 * K, t, 3), rnd(5, 24, m)

    root = kernels.BUILD_DIR / f"coo_head_trials_{os.getpid()}"
    root.mkdir(parents=True)
    cu = (kernels.CSRC / "coo.cu").read_text()
    sources, inc = {}, ["-I", str(kernels.CSRC)]
    for name, spec in VARIANTS.items():
        path = root / f"coo{len(sources)}.cu"
        path.write_text(variant_source(cu, spec))
        sources[name] = (path, inc)
    sigs = {name: kernels.SIGNATURES for name in VARIANTS}
    if args.parent:
        psrc = Path(args.parent) / "latticeum_tpu_torch" / "csrc" / "coo.cu"
        sources["parent"] = (psrc, ["-I", str(psrc.parent)])
        sigs["parent"] = trial_tools.signatures(args.parent)
    p = kernels.ptr
    try:
        built = trial_tools.build(sources, root)
        if args.sass:
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            tool = Path(kernels.nvcc()).parent / "cuobjdump"
            for i, (name, (lib, _)) in enumerate(built.items()):
                text = subprocess.run([str(tool), "-sass", lib._name],
                                      capture_output=True, text=True).stdout
                (Path(args.sass) / f"v{i}.sass").write_text(
                    f"// {name}\n" + text)
        libs = {}
        for name, (lib, _) in built.items():
            for fn in ("lt_coo_matvec", "lt_coo_head"):
                if fn in sigs[name]:
                    getattr(lib, fn).argtypes = sigs[name][fn]
                    getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        parent_head = "parent" in libs and "lt_coo_head" not in sigs["parent"]

        def head_run(name, csr, zs, zeta, out0, out1):
            """Both c rows, out0 and out1 (24, nseg), in one call."""
            ring = int(csr.vals.dim() == 2)
            nseg, k = csr.nseg, zs.shape[0] // 2
            if name == "parent" and parent_head:
                fn = libs[name].lt_coo_matvec
                # its head mode lists the segments by size, the heavy first
                by_size = np.argsort(-csr.sizes, kind="stable")
                n_heavy = int(np.count_nonzero(csr.sizes * k >
                                               accel.COO_LIGHT))
                full = csr.full[torch.from_numpy(by_size).to(dev)]

                def run():
                    for r, out in enumerate((out0, out1)):
                        err = fn(p(csr.off), p(csr.gather), p(csr.mats),
                                 p(csr.vals), p(full), n_heavy,
                                 csr.sizes.size, nseg, nseg,
                                 p(zs[r * k:(r + 1) * k]), zs.shape[1],
                                 p(zeta[r * k:(r + 1) * k]), k,
                                 zeta.shape[1], ring, 1, p(out),
                                 kernels.stream())
                        assert err == 0, err
                return run
            fn = libs[name].lt_coo_head

            def run():
                err = fn(p(csr.full), p(csr.nz_off), csr.sizes.size,
                         p(csr.gather), p(csr.mats), p(csr.vals), ring,
                         p(zs), zs.shape[1], p(zeta), k, zeta.shape[1],
                         nseg, p(out0), p(out1), kernels.stream())
                assert err == 0, err
            return run

        heads = list(libs)
        result = {name: {"rewrites": VARIANTS.get(name, {}),
                         "ptxas": [f"{f}: {r} registers"
                                   + (f", {s} B spilled" if s else "")
                                   for f, r, s in trial_tools.ptxas(
                                       built[name][1], "coo")]}
                  for name in libs}
        # every launch of every variant on its own, synchronized
        checks = ragged_maps(rng, dev) + [
            (f"production, {kind}", csr, zs, zeta, base[1:4:2])
            for kind, csr in csrs.items()]
        for case, csr, z, ze, outs in checks:
            want = outs.clone()
            accel.coo_head_twin(csr, z, ze, (want[0], want[1]))
            for name in heads:
                got = outs.clone()
                head_run(name, csr, z, ze, got[0], got[1])()
                try:
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    raise SystemExit(f"{name}, {case}: {exc}") from exc
                if VARIANTS.get(name, {}).get("exact", True) and \
                        not torch.equal(got, want):
                    raise SystemExit(f"{name}, {case}: differs from the "
                                     "twin")
            result.setdefault("checked, each launch synchronized",
                              []).append(case)
        for kind, csr in csrs.items():
            runs = {}
            for name in heads:
                out = base.clone()
                runs[name] = head_run(name, csr, zs, zeta, out[1], out[3])
            for name, run in runs.items():
                result[name][f"{kind} graph ms"] = graph_ms(run)
            for rep in range(2):
                for name in (list(runs) if rep == 0 else list(runs)[::-1]):
                    result[name].setdefault(
                        f"{kind} events ms", []).append(events_ms(runs[name]))
            del runs
            torch.cuda.empty_cache()
        if args.parent:
            plain = [name for name in VARIANTS
                     if name == next(iter(VARIANTS))
                     or VARIANTS[name].get("plain")]
            result["plain modes, graph ms"] = plain_modes(
                libs, plain, ccs, rows, cols, mats, vals, ring_vals, rnd,
                dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"card": trial_tools.card(), "variants": result}),
          flush=True)


def plain_modes(libs, mine, ccs, rows, cols, mats, vals, ring_vals, rnd,
                dev):
    """coo_kernel of the variants `mine` and of the parent at the M z and
    M^T eq maps, scalar and ring values, each held against the twin and
    timed by a CUDA graph of 20, in turns (parent, mine, mine reversed,
    parent)."""
    n, t = ccs.n, ccs.t
    cap = min(1 << int(rows.max()).bit_length(), ccs.m)
    maps = {"mz_stack": (mats * cap + tables.brev_host(cap).numpy()[rows],
                         cols, t * cap, cap, True, rnd(n, 24)),
            "mt_eq_stack": (mats * n + cols, rows, t * n, n, False,
                            rnd(cap, 24))}
    p = kernels.ptr
    out = {}
    for name, (seg, gather, nseg, per, t_layout, x) in maps.items():
        for kind, v in (("scalar", vals), ("ring", ring_vals)):
            csr = accel.build_csr(seg, gather, mats, v, nseg, per, dev)
            shape = accel.coo_out_shape(csr, t_layout)
            want = accel.coo_matvec_twin(
                csr, x, torch.empty(shape, dtype=gl.DTYPE, device=dev),
                t_layout)
            ring = int(v.ndim == 2)
            runs = {}
            for lib_name in ["parent", *mine]:
                fn = libs[lib_name].lt_coo_matvec
                got = torch.empty(shape, dtype=gl.DTYPE, device=dev)
                if len(fn.argtypes) > 13:        # the parent's head mode
                    def run(fn=fn, got=got):
                        err = fn(p(csr.off), p(csr.gather), None,
                                 p(csr.vals), p(csr.full), csr.n_heavy(),
                                 csr.sizes.size, nseg, per, p(x), 1, None,
                                 1, 1, ring, int(t_layout), p(got),
                                 kernels.stream())
                        assert err == 0, err
                else:
                    def run(fn=fn, got=got):
                        err = fn(p(csr.off), p(csr.gather), p(csr.vals),
                                 p(csr.full), csr.n_heavy(),
                                 csr.sizes.size, nseg, per, p(x), ring,
                                 int(t_layout), p(got), kernels.stream())
                        assert err == 0, err
                run()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"{lib_name} {name} {kind} disagrees")
                runs[lib_name] = run
            order = list(runs)
            for lib_name in order + order[::-1]:
                out.setdefault(f"{name} {kind} {lib_name}", []).append(
                    graph_ms(runs[lib_name]))
            del csr, want, runs
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
