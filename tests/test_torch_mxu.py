"""The port's digit-plane contraction (``latticeum_tpu_torch/field/mxu.py``)
against the JAX package's ``latticeum_tpu/field/mxu.py`` and a Python-int
oracle, and the evaluation claims that route through it.

On the CPU the wrappers run their plain-torch twins (``digit_split_twin``,
``plane_recombine_twin``) around ``torch._int_mm``; the ``cuda`` tests hold
the CUDA kernels of ``csrc/mxu.cu`` against those twins on the card.
Tolerance everywhere: none (exact integers)."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref, host as H, mxu as mxu_ref
from latticeum_tpu.nifs import decomposition as dec, linearization as lin
from latticeum_tpu.nifs.structs import Witness
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_L, get_test_ccs,
                                              get_test_z, z_to_device)
from latticeum_tpu_torch.field import goldilocks as gl, mxu
from latticeum_tpu_torch.ring import rq
from latticeum_tpu_torch.zkvm import claims
from latticeum_tpu_torch.zkvm.accel import Engine

P = gl.P
EDGES = [0, 1, P - 1, P // 2, P // 2 + 1, 0xFF00FF00FF00FF00 % P,
         (1 << 63) % P, ((1 << 64) - 1) % P, 0x8000000000000000 % P,
         0x7FFFFFFFFFFFFFFF]


def rings(rng, *shape):
    """Random canonical rings, shape + (24,), as Python ints, with the
    largest values in the first entries (they reach the carry plane)."""
    vals = rng.integers(0, P, size=shape + (24,), dtype=np.uint64).astype(
        object)
    vals.reshape(-1, 24)[0] = P - 1
    vals.reshape(-1, 24)[-1] = (1 << 63) + 12345
    return vals


def tensor(vals):
    return gl.from_int(vals)


def oracle(A, Bv):
    """out[j, k] = sum_n A[j, n] * B[k, n] over Python ints."""
    t, n = A.shape[:2]
    out = np.empty((t, Bv.shape[0], 24), dtype=object)
    for j in range(t):
        for k in range(Bv.shape[0]):
            acc = H.ntt_zero()
            for i in range(n):
                acc = H.ntt_add(acc, H.ntt_mul(list(A[j, i]), list(Bv[k, i])))
            out[j, k] = acc
    return out


def jax_ring_contract(A, Bv):
    with B.jax_mode():
        a = tuple(B.xp.asarray(np.asarray(x)) for x in gl_ref.from_int(A))
        b = tuple(B.xp.asarray(np.asarray(x)) for x in gl_ref.from_int(Bv))
        out = mxu_ref.ring_contract(a, b)
        return gl_ref.to_int((np.asarray(out[0]), np.asarray(out[1])))


def port_ring_contract(A, Bv, t_layout):
    a, b = tensor(A), tensor(Bv)
    if t_layout:
        a, b = a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous()
    return np.array(gl.to_int_lists(mxu.ring_contract(a, b, t_layout)),
                    dtype=object)


def test_digit_planes_match_jax_and_recompose():
    rng = np.random.default_rng(7)
    vals = np.array(EDGES + [int(x) for x in rng.integers(
        0, P, size=5000, dtype=np.uint64)], dtype=object)
    got = mxu.digit_planes(tensor(vals))
    with B.numpy_mode():
        want = np.asarray(mxu_ref.digit_planes(gl_ref.from_int(vals)))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    d = got.numpy().astype(object)
    back = sum(d[:, i] * (1 << (8 * i)) for i in range(mxu.NPLANES))
    assert np.all(back == vals)


@pytest.mark.parametrize("t_layout", [False, True], ids=["standard", "t"])
def test_ring_contract_matches_oracle_and_jax(t_layout):
    rng = np.random.default_rng(3)
    A, Bv = rings(rng, 3, 100), rings(rng, 2, 100)
    got = port_ring_contract(A, Bv, t_layout)
    assert np.array_equal(got, oracle(A, Bv))
    assert np.array_equal(got, jax_ring_contract(A, Bv))


@pytest.mark.parametrize("t_layout", [False, True], ids=["standard", "t"])
def test_ring_contract_chunked(monkeypatch, t_layout):
    """n = 37 in chunks of 8 columns on both sides (the last one a column
    of data and 7 of padding on the port's side)."""
    monkeypatch.setattr(mxu, "CHUNK_N", 8)
    monkeypatch.setattr(mxu_ref, "CHUNK_N", 8)
    rng = np.random.default_rng(4)
    A, Bv = rings(rng, 2, 37), rings(rng, 1, 37)
    got = port_ring_contract(A, Bv, t_layout)
    assert np.array_equal(got, oracle(A, Bv))
    assert np.array_equal(got, jax_ring_contract(A, Bv))


@pytest.mark.parametrize("rows,n,chunk", [(1, 5, 1 << 16), (3, 40, 16),
                                          (4, 33, 8)])
def test_digit_split_layout_and_padding(monkeypatch, rows, n, chunk):
    """Chunk c holds (8, rows_pad, width): plane row (3 j + i) 9 + d of
    slot s at column c chunk + x, zero in every padding row and column."""
    monkeypatch.setattr(mxu, "CHUNK_N", chunk)
    rng = np.random.default_rng(rows * n)
    x = tensor(rings(rng, rows, n))
    pl = mxu.digit_split(x)
    assert (pl.rows_pad % mxu.ROW_ALIGN, pl.n_pad % mxu.COL_ALIGN) == (0, 0)
    assert pl.rows_pad >= 27 * rows and pl.data.numel() == \
        8 * pl.rows_pad * pl.n_pad
    full = torch.cat(list(pl.chunks()), dim=-1)          # (8, rows_pad, n_pad)
    d = mxu.digit_planes(x.reshape(rows, n, 8, 3))       # (rows, n, 8, 3, 9)
    want = torch.zeros_like(full)
    want[:, :27 * rows, :n] = d.permute(2, 0, 3, 4, 1).reshape(8, -1, n)
    assert torch.equal(full, want)


def test_plane_recombine_adds_to_running_sum():
    """Two chunks of plane products recombine to the oracle, the second
    added to the first; negative int32 products map to p - |v|."""
    rng = np.random.default_rng(5)
    t, kb = 2, 3
    O = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30,
                                      (2, 8, 56, 88), dtype=np.int32))
    out = torch.zeros((t, kb, 24), dtype=gl.DTYPE)
    for o in O:
        mxu.plane_recombine(o, out)
    want = np.zeros((t, kb, 24), dtype=object)
    for o in O.numpy().astype(object):
        blk = o[:, :27 * t, :27 * kb].reshape(8, t, 3, 9, kb, 3, 9)
        for i, i2, comp, w in mxu.FQ3_TERMS:
            scale = mxu.W_NONRESIDUE if w else 1
            for dA in range(9):
                for dB in range(9):
                    v = blk[:, :, i, dA, :, i2, dB] * (scale << (8 * (dA + dB)))
                    want[:, :, comp::3] += np.moveaxis(v, 0, -1)
    assert gl.to_int_lists(out) == (want % P).tolist()


def test_claims_route_matches_slotwise():
    """eval_claims / eval_fhat through ring_contract equal the slot-wise
    products and the JAX package's host claims on the test CCS."""
    ccs = get_test_ccs()
    e = Engine(ccs, "cpu")
    rng = np.random.default_rng(2)
    point = [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
             for _ in range(ccs.s)]
    z = torch.stack([e.ints(get_test_z(x)) for x in (3, 5, 7)])
    eqT = e.mt_eq_stack(e.eq_table(point, ccs.m))
    u = claims.eval_claims(eqT, z)
    assert torch.equal(u, claims.eval_claims_slotwise(eqT, z))
    with B.numpy_mode():
        host_u = dec.eval_claims_via_eqT(dec.eq_transposed_rows(ccs, point),
                                         z_to_device(get_test_z(3)))
    assert gl.to_int_lists(u[0]) == host_u
    wit = Witness.from_w_ccs(z_to_device(get_test_z(3)[2:]), TEST_B, TEST_L)
    fh = gl.from_limbs(wit.f_hat)                         # (TAU, npad, 24)
    fh_t = torch.stack([fh, fh]).transpose(-1, -2).contiguous()
    npad = fh.shape[-2]
    eq_t = e.eq_table(point, npad).T.contiguous()
    v = claims.eval_fhat(fh_t, eq_t)
    assert torch.equal(v, claims.eval_fhat_slotwise(fh_t, eq_t))
    assert gl.to_int_lists(v[1]) == lin.evaluate_mles_host(wit.f_hat, point)


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,t_layout", [(1, 1, False), (3, 100, True),
                                             (125, 2000, False),
                                             (45, 70000, True)])
def test_digit_split_kernel_matches_twin(rows, n, t_layout):
    dev = _cuda()
    rng = np.random.default_rng(rows + n)
    shape = (rows, 24, n) if t_layout else (rows, n, 24)
    x = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, P, shape, dtype=np.uint64))).to(dev)
    x.view(-1)[:len(EDGES)] = gl.from_int(EDGES, dev)
    n0 = mxu.digit_split.launches
    got = mxu.digit_split(x, t_layout)
    assert mxu.digit_split.launches == n0 + 1
    assert torch.equal(got.data, mxu.digit_split_twin(x, t_layout).data)


@pytest.mark.cuda
@pytest.mark.parametrize("t,kb", [(1, 1), (3, 2), (7, 17), (45, 1), (3, 1),
                                  (125, 15), (125, 30)])
def test_plane_recombine_kernel_matches_twin(t, kb):
    """Two chunks' products added in turn into one running sum, at edge
    shapes and the four production shapes of the claims (dec v 45 x 1,
    lin v 3 x 1, dec u 125 x 15, fold eta 125 x 30)."""
    dev = _cuda()
    rng = np.random.default_rng(t * kb)
    ra, rb = -(-27 * t // 8) * 8, -(-27 * kb // 8) * 8
    start = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, P, (t, kb, 24), dtype=np.uint64))).to(dev)
    got, want = start.clone(), start.clone()
    n0 = mxu.plane_recombine.launches
    for _ in range(2):
        O = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, ra, rb),
                                          dtype=np.int64).astype(np.int32))
        O.view(-1)[:4] = torch.tensor([-(1 << 31), (1 << 31) - 1, -1, 0],
                                      dtype=torch.int32)
        mxu.plane_recombine(O.to(dev), got)
        mxu.plane_recombine_twin(O.to(dev), want)
    assert mxu.plane_recombine.launches == n0 + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ring_contract_on_card_matches_slotwise():
    dev = _cuda()
    rng = np.random.default_rng(11)
    A = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, P, (5, 70000, 24), dtype=np.uint64))).to(dev)
    Bv = torch.from_numpy(gl.to_i64_bits(rng.integers(
        0, P, (3, 70000, 24), dtype=np.uint64))).to(dev)
    assert torch.equal(mxu.ring_contract(A, Bv),
                       gl.sum_axis(rq.ntt_mul(A[:, None], Bv[None]), -2))
