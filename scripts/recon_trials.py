"""Build the lin reconstruction tail's kernel in design variants and time
each at the main path's shape, on a machine with a card and the CUDA
toolkit:

    python3 scripts/recon_trials.py

Each variant is a copy of ``latticeum_tpu_torch/csrc/recon.cu`` with some
of its lines rewritten (``VARIANTS``), compiled with the headers of
``csrc/`` by its own nvcc, all at once, each into a library of its own
under a fresh directory of ``_build/`` (``trial_tools.build``).  Every
variant runs the tail of the zkVM's lin sum-check as the main path runs
it (its 125 Mz rows and 52
multisets with their +-1 signs, 3 rounds after 14 factored ones, a table
of 8 columns, 9 points), is timed by a CUDA graph of 50 launches, twice,
the variants in turns, and, where it still computes the tail, is held bit
for bit against ``comb.lin_recon_tail_twin`` (the variants that leave out
the permutations or the sums measure what is left).  Beside them:
``perm16_chain`` at the tail's 63 permutations and at none (the launch),
and ``round_tail`` unweighted at a round's 21.  Prints one JSON line: the
card (``nvidia-smi`` name and power limit), per variant (by name) its
ptxas registers, whether it computes the tail bit for bit and its times
in ms, and the times beside them.  The directories are removed.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from latticeum_tpu_torch import kernels  # noqa: E402
from latticeum_tpu_torch.crypto import challenger  # noqa: E402
from latticeum_tpu_torch.field import goldilocks as gl  # noqa: E402
from latticeum_tpu_torch.parallel import lin_mesh  # noqa: E402
from latticeum_tpu_torch.zkvm import comb  # noqa: E402
import trial_tools  # noqa: E402

# Rewrites of recon.cu: (old text, new text), each found exactly once.
NO_CHAIN = ("s = permute16(s, kt, diag, lane);", "s = s + 1;")
NO_SUMS = ("for (int rk = g; rk < nsets; rk += G) {",
           "for (int rk = g; rk < 0; rk += G) {")
INDEX_ORDER = ("    order[rank] = i;", "    order[i] = i + 0 * rank;")
TWO_CHAINS = ("""        Fq3 prod = at_point(T, W, idx[off[i]], x, h, t);
        for (int kk = off[i] + 1; kk < off[i + 1]; ++kk)
          prod = fq3_mul(prod, at_point(T, W, idx[kk], x, h, t));
""", """        const int k1 = off[i + 1];
        int kk = off[i] + 1;
        Fq3 prod = at_point(T, W, idx[kk - 1], x, h, t);
        if (kk < k1) {
          Fq3 pb = at_point(T, W, idx[kk++], x, h, t);
          for (; kk + 1 < k1; kk += 2) {
            const Fq3 fa = at_point(T, W, idx[kk], x, h, t);
            const Fq3 fb = at_point(T, W, idx[kk + 1], x, h, t);
            prod = fq3_mul(prod, fa);
            pb = fq3_mul(pb, fb);
          }
          if (kk < k1) prod = fq3_mul(prod, at_point(T, W, idx[kk], x, h, t));
          prod = fq3_mul(prod, pb);
        }
""")
BLOCK_BARRIER = ("""      if (k == nv - 1 && lane < CH_WIDTH) state[lane] = s;
    }
    cluster.sync();""", """      if (k == nv - 1 && lane < CH_WIDTH) state[lane] = s;
    }
    __syncthreads();
    cluster.sync();""")
RHO_ONCE = ("const Fq3 rho = get3(chal0);", """__shared__ u64 rho_s[3];
    if (tid < 3) rho_s[tid] = chal0[tid];
    __syncthreads();
    const Fq3 rho = get3(rho_s);""")
THREADS_1024 = ("#define RC_THREADS 512", "#define RC_THREADS 1024")
NOINLINE_FN = ("""}  // namespace

// mz (t_rows, 24, 2)""", """__device__ __noinline__ u64 absorb_sample(u64 s, const u64 *kt, u64 diag,
                                          int lane, const u64 *buf, int L,
                                          u64 *cv) {
  const int e = lane & 15;
  const int nabs = (L + CH_RATE - 1) / CH_RATE;
  u64 c0 = 0, c1 = 0, c2 = 0, ce = 0;
  for (int c = 0; c < nabs + 2; ++c) {
    if (c == nabs) {
      c0 = __shfl_sync(CH_FULL, s, 11);
      c1 = __shfl_sync(CH_FULL, s, 10);
      c2 = __shfl_sync(CH_FULL, s, 9);
      ce = e % 3 == 0 ? c0 : (e % 3 == 1 ? c1 : c2);
    }
    if (c < nabs) {
      if (e < min(CH_RATE, L - CH_RATE * c)) s = buf[CH_RATE * c + e];
    } else if (e < CH_RATE) {
      s = ce;
    }
    s = permute16(s, kt, diag, lane);
  }
  if (lane == 0) {
    cv[0] = c0;
    cv[1] = c1;
    cv[2] = c2;
  }
  return s;
}

}  // namespace

// mz (t_rows, 24, 2)""")
NOINLINE_CALL = ("""      const int e = lane & 15;
      const int L = npk + 24 * npts;
      const int nabs = (L + CH_RATE - 1) / CH_RATE;
      u64 c0 = 0, c1 = 0, c2 = 0, ce = 0;
      for (int c = 0; c < nabs + 2; ++c) {
        if (c == nabs) {
          c0 = __shfl_sync(CH_FULL, s, 11);
          c1 = __shfl_sync(CH_FULL, s, 10);
          c2 = __shfl_sync(CH_FULL, s, 9);
          ce = e % 3 == 0 ? c0 : (e % 3 == 1 ? c1 : c2);
        }
        if (c < nabs) {
          if (e < min(CH_RATE, L - CH_RATE * c)) s = buf[CH_RATE * c + e];
        } else if (e < CH_RATE) {
          s = ce;
        }
        s = permute16(s, kt, diag, lane);
      }
      if (lane == 0) {
        const Fq3 cv = Fq3{c0, c1, c2};""", """      s = absorb_sample(s, kt, diag, lane, buf, npk + 24 * npts, chal);
      __syncwarp();
      if (lane == 0) {
        const Fq3 cv = get3(chal);""")

# name: (rewrites, whether the variant still computes the tail)
VARIANTS = {
    "the kernel": ((), True),
    "multisets in index order": ((INDEX_ORDER,), True),
    "two product chains a thread": ((TWO_CHAINS,), True),
    "block barrier for block 0's idle warps": ((BLOCK_BARRIER,), True),
    "challenge read once a block": ((RHO_ONCE,), True),
    "challenger not inlined": ((NOINLINE_FN, NOINLINE_CALL), True),
    "blocks of 1024 threads": ((THREADS_1024,), True),
    "no permutations": ((NO_CHAIN,), False),
    "no sums": ((NO_SUMS,), False),
    "no permutations, no sums": ((NO_CHAIN, NO_SUMS), False),
}
NV, R, NPTS = 17, 14, 9      # the main path's lin sum-check and its tail


def variant_source(text, rewrites):
    """recon.cu's text with the rewrites made; raises unless each finds
    its text exactly once."""
    for old, new in rewrites:
        n = text.count(old)
        if n != 1:
            raise RuntimeError(f"recon.cu: {n} places to rewrite "
                               f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    return text


def build(out_dir):
    """{name: (library, ptxas registers of the kernel)}, every variant
    compiled by its own nvcc, all at once."""
    src = (kernels.CSRC / "recon.cu").read_text()
    sources = {}
    for name, (rewrites, _) in VARIANTS.items():
        path = out_dir / f"recon{len(sources)}.cu"
        path.write_text(variant_source(src, rewrites))
        sources[name] = (path, ["-I", str(kernels.CSRC)])
    out = {}
    for name, (lib, text) in trial_tools.build(sources, out_dir).items():
        lib.lt_lin_recon_tail.argtypes = kernels.SIGNATURES[
            "lt_lin_recon_tail"]
        lib.lt_lin_recon_tail.restype = ctypes.c_int
        out[name] = (lib, [r for _, r, _ in trial_tools.ptxas(text)])
    return out


def graph_ms(fn):
    """Device time per call of fn: 50 calls in a CUDA graph, replayed."""
    return trial_tools.graph_ms(fn, reps=50, replays=5)


def main():
    if not torch.cuda.is_available():
        print("recon_trials: no CUDA device", file=sys.stderr)
        return 2
    card = trial_tools.card()
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="recon_trials_",
                                    dir=kernels.BUILD_DIR))
    try:
        libs = build(out_dir)
        kernels.lib()
        S, signs, t_rows = lin_mesh._zkvm_S_c()
        sets = comb.lin_sets(S, signs, t_rows, "cuda")
        rng = np.random.default_rng(1)

        def rnd(*shape):
            return torch.from_numpy(gl.to_i64_bits(rng.integers(
                0, gl.P, shape, dtype=np.uint64))).cuda()
        x = [rnd(t_rows, 24, 2), rnd(NV - R, 3), rnd(3), rnd(16), rnd(5),
             torch.zeros((NV, NPTS, 24), dtype=gl.DTYPE, device="cuda"),
             rnd(NV, 3)]
        want = [t.clone() for t in x]
        want_final = comb.lin_recon_tail_twin(*want, sets, R)
        final = torch.empty((t_rows + 1, 24), dtype=gl.DTYPE, device="cuda")

        def p(t):
            return ctypes.c_void_p(t.data_ptr())

        def call(lib, v):
            mz, betas, scale, state, _, msgs, chals = v
            err = lib.lt_lin_recon_tail(
                p(mz), t_rows, p(betas), p(scale), p(state), p(chals[R - 1]),
                3, p(msgs), p(chals), p(challenger.kernel_consts(mz.device)),
                *comb._sets_args(sets)[:4], len(sets.S), sets.idx.numel(),
                NPTS, NV, R, p(final), kernels.stream())
            if err:
                raise RuntimeError(f"lt_lin_recon_tail: cudaError {err}")
        res = {}
        for name, (lib, regs) in libs.items():
            v = [t.clone() for t in x]
            call(lib, v)
            torch.cuda.synchronize()
            exact = (torch.equal(final, want_final)
                     and all(torch.equal(a, b) for a, b in zip(v, want)))
            if VARIANTS[name][1] and not exact:
                raise RuntimeError(f"{name}: differs from the twin")
            res[name] = {"registers": regs, "exact": exact, "ms": []}
        st = rnd(16)
        sums, pend = rnd(NPTS, 24), rnd(3)
        msgs = torch.zeros((4, NPTS, 24), dtype=gl.DTYPE, device="cuda")
        chals = torch.zeros((4, 3), dtype=gl.DTYPE, device="cuda")
        other = {"perm16_chain 63": [], "perm16_chain 0": [],
                 "round_tail unweighted": []}
        for _rep in range(2):
            for name, (lib, _) in libs.items():
                v = [t.clone() for t in x]
                res[name]["ms"].append(graph_ms(lambda: call(lib, v)))
            other["perm16_chain 63"].append(graph_ms(
                lambda: challenger.perm16_chain(st, 63)))
            other["perm16_chain 0"].append(graph_ms(
                lambda: challenger.perm16_chain(st, 0)))
            other["round_tail unweighted"].append(graph_ms(
                lambda: challenger.round_tail(sums, None, None, None, st,
                                              pend, msgs, chals, 2,
                                              weighted=False)))
        print(json.dumps({"card": card, "variants": res, "beside": other}))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
