"""Build and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles ``csrc/comb.cu`` for sm_90a into a shared library with a
plain C interface, which ``ctypes`` loads.  The library is built at first use
into ``_build/`` (listed in ``.gitignore``) under a name that carries the
hash of the sources, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("comb.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_info = {}    # seconds, command and compiler output of the last build


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"libltcomb_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.time() - t0, command=" ".join(cmd),
                      output=res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    so = ctypes.CDLL(str(build()))
    vp, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint64)
    sigs = {
        "lt_fold_round0": [vp] * 5 + [i32, i64, i32, vp],
        "lt_fold_roundr": [vp] * 6 + [i32, i64, u64, u64, u64, i32, vp],
        "lt_lin_round0": [vp] * 5 + [i32, vp, vp, i64, i32, vp],
        "lt_lin_roundr": [vp] * 6 + [i32, vp, vp, i64, u64, u64, u64, i32,
                                     vp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.lt_error_string.argtypes = [ctypes.c_int]
    so.lt_error_string.restype = ctypes.c_char_p
    _lib = so
    return _lib


def error_string(err: int) -> str:
    return lib().lt_error_string(err).decode()
