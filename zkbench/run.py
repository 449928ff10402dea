"""Run one cell of the benchmark once and print its result.

    python3 zkbench/run.py --workload fib_1mb.loop --seed 7 --seconds 45 \\
        --trace 0

The last line of standard output is the result's JSON object; the checks
that decided `correct` are the last lines of standard error.  Exit code 0
with a result; 2 without one (no CUDA device, an unknown cell, a module
of jax or the JAX package loaded).  See README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="break the timed path (the control and the tests)")
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / ".zkbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread for numpy's BLAS and torch's CPU ops: the load of
    # one process with few threads, which spreads least on shared cores
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from zkbench import harness

    try:
        result, bad, _ = harness.run(args.workload, args.seed, args.seconds,
                                     args.trace, T_START, fault=args.fault)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"refused: the program cannot be imported here: {e}",
              file=sys.stderr)
        return 2
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(harness.FORBIDDEN))
    if found:
        print(f"refused: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 2
    result["checks"] = {f"{k}_mismatches": {"value": v, "limit": 0}
                        for k, v in bad.items()}
    for k, v in bad.items():
        print(f"check {k}_mismatches: {v} (limit 0)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
