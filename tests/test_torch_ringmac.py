"""The ring multiply-accumulate (``rq.ring_mac``, ``rq.ring_mul_each``;
``csrc/ringmac.cu``) and its callers in the port's fold step, against the
JAX package under numpy: the fold's f0 combination (``f0_fn``,
``latticeum_tpu/zkvm/accel_nifs.py:796``: ``rq.ntt_mul`` then
``gl.sum_axis``) and dec's row-constant commits and y0 (``batch_fn``'s
expressions, ``:508-517``), and the running-product Fq3 powers of the
fold head against ``fq3_pow``.  Tolerance: none (exact integers).  The
tests marked ``cuda`` hold the kernel against its twins on a card and skip
elsewhere."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref, host as H_ref
from latticeum_tpu.ring import rq as rq_ref
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.ring import rq
from latticeum_tpu_torch.zkvm import accel_nifs

P = gl.P


def rings(rng, *shape):
    u = rng.integers(0, P, shape + (24,), dtype=np.uint64)
    if u.size:
        u.reshape(-1, 24)[0] = P - 1      # a ring of p - 1 in every part
    return u


def t(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def ref(u):
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def ints(limbs):
    return gl_ref.to_int((np.asarray(limbs[0]),
                          np.asarray(limbs[1]))).astype(np.uint64)


@pytest.mark.parametrize("n_a,n_b,rows", [(2, 2, 37), (1, 3, 5), (4, 0, 1),
                                          (15, 15, 3)])
def test_ring_mac_matches_jax_f0(n_a, n_b, rows):
    """f0 = sum_i rho_i f_i over two batches read where they lie, as
    f0_fn computes it over their concatenation."""
    rng = np.random.default_rng(100 * n_a + 10 * n_b + rows)
    fa, fb = rings(rng, n_a, rows), rings(rng, n_b, rows)
    rho = rings(rng, n_a + n_b)
    parts = (t(fa),) if n_b == 0 else (t(fa), t(fb))
    got = rq.ring_mac(parts, t(rho))
    fs = np.concatenate([fa, fb])
    with B.numpy_mode():
        want = gl_ref.sum_axis(rq_ref.ntt_mul(ref(fs), ref(rho[:, None])),
                               axis=0)
    assert got.shape == (rows, 24)
    assert np.array_equal(gl.to_u64(got), ints(want))


@pytest.mark.parametrize("kappa,K,nf", [(3, 3, 37), (4, 2, 5), (32, 15, 9)])
def test_commits_and_y0_match_jax_batch_fn(kappa, K, nf):
    """dec's row-constant commits cm_k = rows * sum f_k (k >= 1) and
    y0 = cm - sum_k b^k cm_k, as batch_fn computes them."""
    rng = np.random.default_rng(7 * kappa + K)
    rows_u, f, cm = rings(rng, kappa), rings(rng, K, nf), rings(rng, kappa)
    b_small = 2
    cms = accel_nifs.row_constant_commits(t(rows_u), t(f[1:]))
    y0 = accel_nifs.recompose_y0(t(cm), cms, b_small)
    with B.numpy_mode():
        total = gl_ref.sum_axis(ref(f[1:]), axis=-2)             # (K-1, 24)
        cms_ref = rq_ref.ntt_mul((ref(rows_u)[0][None], ref(rows_u)[1][None]),
                                 (total[0][:, None], total[1][:, None]))
        bp = gl_ref.from_int(np.array([pow(b_small, k, P)
                                       for k in range(1, K)], dtype=object))
        acc = gl_ref.mul((bp[0][:, None, None], bp[1][:, None, None]),
                         cms_ref)
        y0_ref = gl_ref.sub(ref(cm), gl_ref.sum_axis(acc, axis=0))
    assert cms.shape == (K - 1, kappa, 24)
    assert np.array_equal(gl.to_u64(cms), ints(cms_ref))
    assert np.array_equal(gl.to_u64(y0), ints(y0_ref))


def test_ring_mac_twins_agree_with_products():
    """ring_mul_each is ntt_mul by each ring; ring_mac with a base
    subtracts; no term sums to zero."""
    rng = np.random.default_rng(5)
    x, c, base = rings(rng, 6), rings(rng, 4), rings(rng, 6)
    each = rq.ring_mul_each(t(x), t(c))
    for i in range(4):
        assert torch.equal(each[i], rq.ntt_mul(t(x), t(c[i])[None]))
    plain = rq.ring_mac((each,), t(np.resize(rings(rng, 1), (4, 24))))
    assert torch.equal(rq.ring_mac((each,), t(c), base=t(base)),
                       gl.sub(t(base), rq.ring_mac((each,), t(c))))
    assert plain.shape == (6, 24)
    empty = torch.zeros((0, 6, 24), dtype=torch.int64)
    assert not rq.ring_mac((empty,), torch.zeros((0, 24),
                                                 dtype=torch.int64)).any()


def test_ring_mac_wrappers_check_their_arguments():
    x = torch.zeros((2, 5, 24), dtype=torch.int64)
    c = torch.zeros((2, 24), dtype=torch.int64)
    with pytest.raises(ValueError):                  # three parts
        rq.ring_mac((x, x, x), torch.zeros((6, 24), dtype=torch.int64))
    with pytest.raises(ValueError):                  # c not one ring a term
        rq.ring_mac((x,), torch.zeros((3, 24), dtype=torch.int64))
    with pytest.raises(ValueError):                  # parts of other rows
        rq.ring_mac((x, x[:, :4]), torch.zeros((4, 24), dtype=torch.int64))
    with pytest.raises(TypeError):
        rq.ring_mac((x.to(torch.int32),), c)
    with pytest.raises(ValueError):                  # base of other rows
        rq.ring_mac((x,), c, base=torch.zeros((4, 24), dtype=torch.int64))
    with pytest.raises(ValueError):                  # x not (rows, 24)
        rq.ring_mul_each(x, c)
    with pytest.raises(ValueError):
        rq.ring_mac((x,), c.to("meta"))
    rq.reset_launches()
    rq.ring_mac((x,), c)
    rq.ring_mul_each(x[0], c)
    assert rq.ring_mac.launches == rq.ring_mul_each.launches == 0  # twins


def test_fq3_powers_match_fq3_pow():
    """The fold head's alpha and zeta powers by a running product equal
    fq3_pow at every exponent, for seeded elements, 0, 1 and p - 1."""
    rng = np.random.default_rng(11)
    xs = [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
          for _ in range(4)]
    xs += [(0, 0, 0), (1, 0, 0), (P - 1, 0, 0), (0, 1, 0), (P - 1,) * 3]
    for x in xs:
        got = accel_nifs.fq3_powers(x, 12)
        assert [tuple(v) for v in got] == [tuple(H_ref.fq3_pow(x, j + 1))
                                           for j in range(12)], x
    assert accel_nifs.fq3_powers(xs[0], 0) == []


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_ring_mac_matches_twin_at_production_shapes():
    """f0 at 2K = 30 terms of nf = 98,815 rings in two batches of 15, and
    dec's commits (kappa = 32 rows by K - 1 = 14 totals) and y0, against
    the twins on the card, bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(21)
    rq.reset_launches()
    fa, fb = t(rings(rng, 15, 98815)).to(dev), t(rings(rng, 15, 98815)).to(dev)
    rho = t(rings(rng, 30)).to(dev)
    assert torch.equal(rq.ring_mac((fa, fb), rho),
                       rq.ring_mac_twin((fa, fb), rho))
    del fa, fb
    rows_u, tot, cm = (t(rings(rng, n)).to(dev) for n in (32, 14, 32))
    cms = rq.ring_mul_each(rows_u, tot)
    assert torch.equal(cms, rq.ring_mul_each_twin(rows_u, tot))
    bp = t(rings(rng, 14)).to(dev)
    assert torch.equal(rq.ring_mac((cms,), bp, base=cm),
                       rq.ring_mac_twin((cms,), bp, base=cm))
    assert rq.ring_mac.launches == 2 and rq.ring_mul_each.launches == 1


@pytest.mark.cuda
def test_cuda_ring_mac_ragged_shapes():
    """Rows around the block (32 rows a block of 256 threads), one part
    and two, 0 to 130 terms (more than the 64 constants a block holds at a
    time), a non-contiguous part."""
    dev = _cuda()
    rng = np.random.default_rng(22)
    rq.reset_launches()
    calls = each = 0
    for rows in (1, 31, 32, 33, 37, 1000):
        for n_a, n_b in ((1, 0), (3, 2), (0, 5), (64, 1), (100, 30)):
            fa = t(rings(rng, n_a, rows)).to(dev)
            parts = (fa,) if n_b == 0 else (fa, t(rings(rng, n_b,
                                                        rows)).to(dev))
            c = t(rings(rng, n_a + n_b)).to(dev)
            base = t(rings(rng, rows)).to(dev)
            for b in (None, base):
                assert torch.equal(rq.ring_mac(parts, c, base=b),
                                   rq.ring_mac_twin(parts, c, base=b)), \
                    (rows, n_a, n_b)
                calls += 1
        x = t(rings(rng, rows)).to(dev)
        for n in (1, 14, 65):
            c = t(rings(rng, n)).to(dev)
            assert torch.equal(rq.ring_mul_each(x, c),
                               rq.ring_mul_each_twin(x, c))
            each += 1
    x = t(rings(rng, 4, 40)).to(dev)[:, ::2]
    c = t(rings(rng, 4)).to(dev)
    assert torch.equal(rq.ring_mac((x,), c), rq.ring_mac_twin((x,), c))
    calls += 1
    assert rq.ring_mac.launches == calls
    assert rq.ring_mul_each.launches == each
