"""State carried between the JAX package and the port.

The JAX package keeps field data as numpy (or jax) ``(lo, hi)`` uint32 limb
pairs, f_hat either in the standard layout (TAU, npad, 24) (host
``Witness``) or in the bit-reversed t-layout (TAU, 24, npad)
(``DeviceWitness``), and the LCCCS accumulator as host Python ints.  The
port keeps one int64 tensor per array and f_hat in the bit-reversed
t-layout.  Each function here converts one piece of state and its inverse
converts it back, so both packages can compute on the same inputs.

Values are read by attribute (``r, v, cm, u, x_w, h`` of an LCCCS;
``w_ccs, f_coeff, f, f_hat`` of a witness) as numpy arrays and ints, so an
object of either package converts; what comes back is always the port's
own (``host.nifs.structs``).
"""

from __future__ import annotations

import numpy as np
import torch

from .field import goldilocks as gl
from .host.nifs.structs import LCCCS, Witness
from .zkvm.accel_nifs import TorchWitness
from .zkvm.tables import brev_host

_LCCCS_FIELDS = ("r", "v", "cm", "u", "x_w")


def ajtai_rows(scheme, device=None):
    """Row-constant AjtaiScheme -> (kappa, 24) tensor of its rows (back:
    ``goldilocks.to_limbs``)."""
    return gl.from_limbs(scheme.rows_limbs, device)


def ccs_coo(ccs, device=None):
    """CCS matrices -> per matrix dict(rows, cols int64; vals int64 (nnz,)
    scalars or (nnz, 24) rings)."""
    out = []
    for M in ccs.M:
        out.append(dict(
            rows=torch.from_numpy(np.asarray(M.rows, np.int64)).to(device),
            cols=torch.from_numpy(np.asarray(M.cols, np.int64)).to(device),
            vals=gl.from_limbs(M.vals, device)))
    return out


def ccs_coo_limbs(coo):
    """Inverse of ccs_coo: per matrix (rows int32, cols int32, vals limbs)."""
    return [(m["rows"].cpu().numpy().astype(np.int32),
             m["cols"].cpu().numpy().astype(np.int32),
             gl.to_limbs(m["vals"])) for m in coo]


def _fhat_std_to_t(f_hat):
    """(..., TAU, npad, 24) standard -> (..., TAU, 24, npad) bit-reversed."""
    return f_hat.transpose(-1, -2)[..., brev_host(f_hat.shape[-2])].contiguous()


def _fhat_t_to_std(f_hat):
    return f_hat[..., brev_host(f_hat.shape[-1])].transpose(-1, -2).contiguous()


def _limbs(x):
    return (np.asarray(x[0]).astype(np.uint32),
            np.asarray(x[1]).astype(np.uint32))


def witness_to_torch(wit, device=None, t_layout=False):
    """Host ``Witness`` (t_layout=False) or ``DeviceWitness`` with a
    t-layout f_hat (t_layout=True) -> TorchWitness."""
    def put(x):
        return gl.from_limbs(_limbs(x), device)
    f_hat = put(wit.f_hat)
    if not t_layout:
        f_hat = _fhat_std_to_t(f_hat)
    return TorchWitness(put(wit.w_ccs), put(wit.f_coeff), put(wit.f), f_hat)


def witness_from_torch(wit):
    """TorchWitness -> host ``Witness`` (limb pairs, standard f_hat)."""
    return Witness(gl.to_limbs(wit.w_ccs), gl.to_limbs(wit.f_coeff),
                   gl.to_limbs(wit.f), gl.to_limbs(_fhat_t_to_std(wit.f_hat)))


def _ints(rings):
    return [[int(v) for v in ring] for ring in rings]


def lcccs(acc):
    """Any package's LCCCS (host ints) -> the port's ``LCCCS``."""
    return LCCCS(**{k: _ints(getattr(acc, k)) for k in _LCCCS_FIELDS},
                 h=[int(v) for v in acc.h])


def lcccs_to_torch(acc, device=None):
    """LCCCS of host ints -> dict of int64 tensors ((k, 24) lists, (24,) h)."""
    d = {k: gl.from_int(getattr(acc, k), device).reshape(-1, 24)
         for k in _LCCCS_FIELDS}
    d["h"] = gl.from_int(acc.h, device)
    return d


def lcccs_from_torch(d):
    return LCCCS(**{k: gl.to_int_lists(d[k]) for k in _LCCCS_FIELDS},
                 h=gl.to_int_lists(d["h"]))
