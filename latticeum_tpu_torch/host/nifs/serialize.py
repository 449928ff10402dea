"""LFProof serialization: canonical byte encoding + sizes.

The reference only logs `LFProof` serialized size (main.rs:231-234,
CanonicalSerialize); here proofs round-trip through a compact binary format
(8 bytes LE per field coefficient, structure-prefixed) so per-step proofs
can be persisted/transported.
"""

from __future__ import annotations

import io
import struct


def _w_rings(buf, rings):
    buf.write(struct.pack("<I", len(rings)))
    for r in rings:
        for v in r:
            buf.write(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))


def _r_rings(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return [[struct.unpack("<Q", buf.read(8))[0] for _ in range(24)]
            for _ in range(n)]


def _w_nested(buf, groups):
    buf.write(struct.pack("<I", len(groups)))
    for g in groups:
        _w_rings(buf, g)


def _r_nested(buf):
    (n,) = struct.unpack("<I", buf.read(4))
    return [_r_rings(buf) for _ in range(n)]


def serialize_proof(proof: dict) -> bytes:
    """LFProof dict (linearization/decomposition_l/decomposition_r/folding)."""
    buf = io.BytesIO()
    lin = proof["linearization"]
    _w_nested(buf, lin["sumcheck"])
    _w_rings(buf, lin["v"])
    _w_rings(buf, lin["u"])
    for side in ("decomposition_l", "decomposition_r"):
        d = proof[side]
        for key in ("u_s", "v_s", "x_s", "y_s"):
            _w_nested(buf, d[key])
    f = proof["folding"]
    _w_nested(buf, f["sumcheck"])
    _w_nested(buf, f["theta_s"])
    _w_nested(buf, f["eta_s"])
    return buf.getvalue()


def deserialize_proof(data: bytes) -> dict:
    buf = io.BytesIO(data)
    lin = {"sumcheck": _r_nested(buf), "v": _r_rings(buf),
           "u": _r_rings(buf)}
    sides = {}
    for side in ("decomposition_l", "decomposition_r"):
        sides[side] = {key: _r_nested(buf)
                       for key in ("u_s", "v_s", "x_s", "y_s")}
    fold = {"sumcheck": _r_nested(buf), "theta_s": _r_nested(buf),
            "eta_s": _r_nested(buf)}
    return {"linearization": lin, **sides, "folding": fold}


def proof_size_bytes(proof: dict) -> int:
    return len(serialize_proof(proof))
