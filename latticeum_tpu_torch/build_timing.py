"""Time the two forms of the kernel library's build, on a machine with the
CUDA toolkit:

    python3 -m latticeum_tpu_torch.build_timing

``kernels.build`` starts one ``nvcc`` per source of ``kernels.SOURCES``, all
at once, and links the objects.  The other form gives every source to one
``nvcc -shared`` call, which compiles them one after the other.  Each build
goes to a fresh directory under ``_build/``, in the order one call,
parallel, parallel, one call; the seconds of each are printed and the
directories removed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time

from . import kernels


def one_call(build_dir):
    cmd = [kernels.nvcc(), *kernels.ARCH_FLAGS, "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", str(build_dir / "libltkernels.so"),
           *(str(kernels.CSRC / s) for s in kernels.SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")


FORMS = {"one call": one_call, "parallel": kernels.build}


def main():
    for name in ("one call", "parallel", "parallel", "one call"):
        build_dir = kernels.BUILD_DIR / f"timing.{os.getpid()}"
        shutil.rmtree(build_dir, ignore_errors=True)
        build_dir.mkdir(parents=True)
        t0 = time.time()
        try:
            FORMS[name](build_dir)
        finally:
            shutil.rmtree(build_dir)
        print(f"build, {name}: {time.time() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
