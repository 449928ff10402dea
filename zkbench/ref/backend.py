"""Array backend of the host protocol: numpy.

Copy of ``latticeum_tpu/backend.py`` with numpy as the only backend.  The
host modules are written against `B.xp` and keep doing so; the port's
device work is torch, outside this package.

Usage:
    from latticeum_tpu_torch.host import backend as B
    B.xp.where(...)
"""

from __future__ import annotations

import contextlib

import numpy as _np

xp = _np

# uint32 wrap-around is intentional throughout the limb arithmetic
_np.seterr(over="ignore")


@contextlib.contextmanager
def numpy_mode():
    yield


def barrier(x):
    """Identity (the JAX package's XLA optimization barrier)."""
    return x


def at_set(arr, idx, value):
    """arr[idx] = value on a copy of arr."""
    out = arr.copy()
    out[idx] = value
    return out


def segment_sum(data, segment_ids, num_segments):
    """Sum rows of `data` into `num_segments` buckets (uint32 wrap-add)."""
    out = _np.zeros((num_segments,) + data.shape[1:], dtype=data.dtype)
    _np.add.at(out, segment_ids, data)
    return out
