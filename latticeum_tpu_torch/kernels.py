"""Build and bind the CUDA kernels of ``csrc/``, and the helpers every
kernel wrapper shares.

``nvcc`` compiles each source of ``SOURCES`` for sm_90a into an object, all
at once in parallel, and links them into one shared library with a plain C
interface, which ``ctypes`` loads.  The library is built at first use into
``_build/`` (listed in ``.gitignore``) under a name that carries the hash of
the sources, so an edited source is rebuilt and an unchanged one is loaded
as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("comb.cu", "poseidon2.cu", "mxu.cu", "challenger.cu",
           "tables.cu", "ring.cu", "coo.cu", "ringmac.cu", "recon.cu",
           "decompose.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
COMPILE_FLAGS = ARCH_FLAGS + ("-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_lib = None
build_info = {}    # seconds, commands and compiler output of the last build


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _run_all(cmds):
    """Start every command at once, wait for all; raise on the first that
    failed.  Returns the joined compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return "".join(outs)


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels into `build_dir` unless a library for these
    sources exists there."""
    tag = source_hash()
    out = build_dir / f"libltkernels_{tag}.so"
    if out.exists():
        return out
    build_dir.mkdir(exist_ok=True)
    pid = os.getpid()
    objs = [build_dir / f"{Path(s).stem}_{tag}.{pid}.o" for s in SOURCES]
    compile_cmds = [[nvcc(), *COMPILE_FLAGS, "-o", str(o), str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)]
    tmp = out.with_suffix(f".{pid}.tmp")
    link_cmd = [nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    t0 = time.time()
    try:
        output = _run_all(compile_cmds) + _run_all([link_cmd])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_info.update(seconds=time.time() - t0,
                      command="\n".join(" ".join(c) for c in
                                        compile_cmds + [link_cmd]),
                      output=output)
    os.replace(tmp, out)
    return out


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The argument types of every C entry point of the library (each returns
# its cudaError_t as an int): a pointer or stream, an int, a long long.
SIGNATURES = {
    "lt_fold_round0": [_VP] * 5 + [_I32, _I64, _I32, _VP],
    "lt_fold_roundr": [_VP] * 6 + [_I32, _I64, _VP, _I32, _VP],
    "lt_lin_round0": [_VP] * 6 + [_I32, _VP, _VP, _I64, _I32, _VP],
    "lt_lin_roundr": [_VP] * 7 + [_I32, _VP, _VP, _I64, _VP, _I32, _VP],
    "lt_lin_recon_tail": [_VP, _I32] + [_VP] * 4 + [_I32] + [_VP] * 7
    + [_I32] * 5 + [_VP] * 2,
    "lt_perm8": [_VP] * 3 + [_I64, _I32, _VP],
    "lt_sponge8": [_VP] * 3 + [_I64, _I64, _I32, _VP],
    "lt_digit_split": [_VP] * 2 + [_I32] * 2 + [_I64] + [_I32] * 5 + [_VP],
    "lt_plane_recombine": [_VP] * 2 + [_I64] * 4 + [_VP],
    "lt_round_tail": [_VP] * 9 + [_I32] * 7 + [_VP],
    "lt_perm16_chain": [_VP] * 2 + [_I32, _VP],
    "lt_eq_table": [_VP] * 2 + [_I32] * 2 + [_VP],
    "lt_head_alpha": [_VP] * 4 + [_I32, _I64, _VP],
    "lt_crt": [_VP] * 2 + [_I64, _I32, _VP, _VP],
    "lt_ring_mac": [_VP] * 2 + [_I32, _I64, _VP, _I32] + [_VP] * 2
    + [_I64, _I32, _VP],
    "lt_coo_matvec": [_VP] * 4 + [_I32] * 2 + [_I64] * 2 + [_VP]
    + [_I32] * 2 + [_VP] * 2,
    "lt_coo_head": [_VP] * 2 + [_I32] + [_VP] * 3 + [_I32, _VP, _I64, _VP]
    + [_I32] * 2 + [_I64] + [_VP] * 3,
    "lt_fold_c_round": [_VP, _I64] * 2 + [_VP] * 4 + [_I64, _VP],
    "lt_pair_sum": [_VP, _I64, _I32, _VP, _I64, _VP],
    "lt_fold_c_end": [_VP, _I64] * 2 + [_VP, _I32] + [_VP] * 3 + [_I64, _VP],
    "lt_balanced_digits": [_VP] * 2 + [_I64] * 4 + [_I32] * 2 + [_VP],
    "lt_digit_recompose": [_VP] * 2 + [_I64] * 5 + [_I32, _VP],
    "lt_row_sums": [_VP] * 3 + [_I32, _I64, _I32, _I64, _VP],
}


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    so = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.lt_error_string.argtypes = [ctypes.c_int]
    so.lt_error_string.restype = ctypes.c_char_p
    _lib = so
    return _lib


def error_string(err: int) -> str:
    return lib().lt_error_string(err).decode()


# -- shared by the kernel wrappers -------------------------------------------

def check(name, t, shape):
    """Raise unless `t` is a contiguous int64 tensor of `shape`."""
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: dtype {t.dtype}, expected int64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def route(tensors):
    """'cpu' (plain twin) or 'cuda' (kernel); all arguments on one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launch(fn_name, *args):
    """Call a C entry point; raise if the cudaError it returns is not 0."""
    err = getattr(lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {err} "
                           f"({error_string(err)})")
