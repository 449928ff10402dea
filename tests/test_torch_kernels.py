"""The ctypes signatures of ``latticeum_tpu_torch/kernels.py`` against the C
entry points of ``csrc/*.cu``: every ``int lt_*(...)`` of the sources has
a signature, with one argument type per parameter (a pointer or stream as
a pointer, ``long long`` as 64 bits, ``int`` as 32), and no signature
names a function the sources lack.  Without it ctypes would pass a Python
int as a 32-bit C int, whatever the parameter's width."""

import ctypes
import re

from latticeum_tpu_torch import kernels


def _entry_points():
    out = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"^int (lt_\w+)\(([^)]*)\)", text, re.M):
            out[m.group(1)] = [" ".join(p.split()) for p in
                               m.group(2).split(",")]
    return out


def _ctype(param):
    if "*" in param or param.startswith("cudaStream_t"):
        return ctypes.c_void_p
    if param.startswith("long long"):
        return ctypes.c_longlong
    if param.startswith("int "):
        return ctypes.c_int
    raise AssertionError(f"parameter type not mapped: {param!r}")


def test_every_entry_point_has_its_signature():
    found = _entry_points()
    assert set(found) == set(kernels.SIGNATURES)
    for name, params in found.items():
        assert kernels.SIGNATURES[name] == [_ctype(p) for p in params], name

