"""The witness pipelines' digit kernels (``csrc/decompose.cu``): the
balanced digits and their recomposition (``ring/decompose.py``) and the
row sums of the row-constant commits (``zkvm/accel_nifs.py`` ``row_sums``).

On the CPU each wrapper runs its plain-torch twin, held here against the
JAX package under numpy (``latticeum_tpu/ring/decompose.py``, and
``batch_fn``'s ``gl.sum_axis`` and ``rq.ntt_mul``,
``latticeum_tpu/zkvm/accel_nifs.py:508-512``) on seeded inputs and edge
values: 0, 1, p - 1, (p - 1)/2, (p + 1)/2, low digits of exactly b/2 and
b/2 + 1 (the carry does not fire, then fires) on both signs, and values
beyond b^K / 2, whose rest both drop.  Tolerance: none (exact integers).
The tests marked ``cuda`` hold each kernel against its twin on a card and
skip elsewhere."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.ring import decompose as dc_ref, rq as rq_ref
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.ring import decompose as dc
from latticeum_tpu_torch.zkvm import accel_nifs

P = gl.P
GADGET = [(1 << 15, 5), (1 << 16, 4)]
K_VECS = [(2, 15), (4, 8)]


def edge_values(b, count):
    """Field values at the edges of the balanced decomposition base b with
    `count` digits."""
    half = b // 2
    vals = [0, 1, P - 1, (P - 1) // 2, (P + 1) // 2,
            half, half + 1, b + half, b + half + 1, half * b + half,
            P - half, P - half - 1, P - b - half, P - b - half - 1]
    top = b ** count // 2                 # beyond it the rest is dropped
    for v in (top - 1, top, top + 1, 3 * top + half + 1):
        if v < P:
            vals += [v, P - v]
    return np.array([v % P for v in vals], dtype=np.uint64)


def rings(seed, b, count, *shape):
    """Seeded rings (shape..., 24) whose first words are the edge values."""
    u = np.random.default_rng(seed).integers(0, P, shape + (24,),
                                             dtype=np.uint64)
    e = edge_values(b, count)
    u.reshape(-1)[:e.size] = e[:u.size]
    return u


def t(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def ref(u):
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def ints(limbs):
    return np.asarray(limbs[0]).astype(np.uint64) | (
        np.asarray(limbs[1]).astype(np.uint64) << np.uint64(32))


def same(x, limbs):
    return x.shape == np.asarray(limbs[0]).shape and \
        np.array_equal(gl.to_u64(x), ints(limbs))


@pytest.mark.parametrize("b,L", GADGET + K_VECS)
def test_decompose_balanced_matches_jax(b, L):
    u = rings(b + L, b, L, 2, 7)
    with B.numpy_mode():
        assert same(dc.decompose_balanced(t(u), b, L),
                    dc_ref.decompose_balanced(ref(u), b, L))


@pytest.mark.parametrize("b,L", GADGET)
def test_gadget_decompose_and_recompose_match_jax(b, L):
    """(2, n, 24) -> (2, n L, 24) and back, a leading batch dimension."""
    u = rings(L, b, L, 2, 9)
    got = dc.gadget_decompose(t(u), b, L)
    with B.numpy_mode():
        assert same(got, dc_ref.gadget_decompose(ref(u), b, L))
        f = rings(L + 1, b, L, 2, 9 * L)      # any field values as digits
        assert same(dc.gadget_recompose(t(f), b, L),
                    dc_ref.gadget_recompose(ref(f), b, L))
    assert np.array_equal(gl.to_u64(dc.gadget_recompose(got, b, L)), u)


@pytest.mark.parametrize("b,K", K_VECS)
def test_decompose_into_k_vecs_matches_jax(b, K):
    """Digits beyond b^K / 2 are dropped the same way (the edge values);
    the k vectors then recompose by Horner in base b as the JAX recompose
    does along their first axis."""
    u = rings(K, b, K, 3, 6)
    got = dc.decompose_vec_into_k_vecs(t(u), b, K)
    with B.numpy_mode():
        assert same(got, dc_ref.decompose_vec_into_k_vecs(ref(u), b, K))
        assert same(dc.recompose(got, b, dim=0),
                    dc_ref.recompose(ref(gl.to_u64(got)), b, axis=0))
    dropped = gl.to_u64(dc.recompose(got, b, dim=0)) != u
    assert dropped.any() and not dropped.all()


@pytest.mark.parametrize("dim", [0, 1, -1, 2])
@pytest.mark.parametrize("b", [2, 1 << 15])
def test_recompose_any_axis_matches_jax(b, dim):
    """Digits that are any field values, including a single digit (taken
    as it is), along each axis."""
    rng = np.random.default_rng(b + dim % 3)
    for count in (1, 3, 9):
        shape = [4, 5, 2]
        shape[dim] = count
        u = rng.integers(0, P, shape, dtype=np.uint64)
        u.reshape(-1)[:3] = [0, P - 1, (P - 1) // 2]
        with B.numpy_mode():
            assert same(dc.recompose(t(u), b, dim),
                        dc_ref.recompose(ref(u), b, axis=dim))


@pytest.mark.parametrize("batch,n", [(1, 5), (1, 600), (14, 37), (3, 1)])
def test_row_constant_commits_match_jax_batch_fn(batch, n):
    """row_sums against gl.sum_axis over the rows, and the commits
    rows * sum f against batch_fn's rq.ntt_mul of the same sums."""
    rng = np.random.default_rng(batch * 1000 + n)
    f = rng.integers(0, P, (batch, n, 24), dtype=np.uint64)
    f[0, 0] = P - 1
    rows_u = rng.integers(0, P, (8, 24), dtype=np.uint64)
    sums = accel_nifs.row_sums(t(f))
    cms = accel_nifs.row_constant_commits(t(rows_u), t(f))
    with B.numpy_mode():
        total = gl_ref.sum_axis(ref(f), axis=-2)
        assert same(sums, total)
        want = rq_ref.ntt_mul((ref(rows_u)[0][None], ref(rows_u)[1][None]),
                              (total[0][:, None], total[1][:, None]))
        assert same(cms, want)


def test_argument_checks():
    x = torch.zeros((3, 24), dtype=torch.int64)
    for fn in (dc.decompose_balanced, dc.gadget_decompose,
               dc.decompose_vec_into_k_vecs):
        with pytest.raises(TypeError):
            fn(x.to(torch.int32), 4, 2)
        for b in (0, 1, 6, 1 << 63):
            with pytest.raises(ValueError):
                fn(x, b, 2)
        with pytest.raises(ValueError):
            fn(x, 4, 0)
        with pytest.raises(ValueError):
            fn(x.to("meta"), 4, 2)                # neither CPU nor card
    with pytest.raises(ValueError):
        dc.recompose(x, 6)
    with pytest.raises(ValueError):
        dc.recompose(torch.zeros((3, 0), dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        dc.recompose(torch.tensor(5), 4)
    with pytest.raises(TypeError):
        dc.gadget_recompose(x.float(), 4, 3)
    with pytest.raises(ValueError):
        dc.gadget_recompose(torch.zeros((10, 24), dtype=torch.int64), 4, 3)
    with pytest.raises(ValueError):
        accel_nifs.row_sums(x)
    with pytest.raises(TypeError):
        accel_nifs.row_sums(x[None].to(torch.int32))
    with pytest.raises(ValueError):
        accel_nifs.row_sums(torch.zeros((1, 3, 8), dtype=torch.int64))


def test_cpu_route_runs_the_twins_and_counts_no_launch():
    dc.reset_launches()
    accel_nifs.row_sums.launches = 0
    u = rings(3, 1 << 15, 5, 4)
    w = dc.gadget_decompose(t(u), 1 << 15, 5)
    assert torch.equal(w, torch.movedim(dc.decompose_balanced_twin(
        t(u), 1 << 15, 5), -1, -2).reshape(20, 24))
    assert torch.equal(dc.gadget_recompose(w, 1 << 15, 5), t(u))
    accel_nifs.row_sums(w[None])
    assert dc.decompose_balanced.launches == dc.recompose.launches == 0
    assert accel_nifs.row_sums.launches == 0


def test_empty_inputs():
    e = torch.zeros((0, 24), dtype=torch.int64)
    assert dc.gadget_decompose(e, 4, 3).shape == (0, 24)
    assert dc.decompose_vec_into_k_vecs(e, 2, 5).shape == (5, 0, 24)
    assert dc.gadget_recompose(e, 4, 3).shape == (0, 24)
    assert torch.equal(accel_nifs.row_sums(e[None]),
                       torch.zeros((1, 24), dtype=torch.int64))


# -- on the card ----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_kernels_match_twins_at_production_shapes():
    """commit_z's gadget digits (19,763 x 24, b = 2^15, L = 5), dec's k
    vectors (98,815 x 24, b = 2, K = 15), dec's and the fold's
    recompositions, dec's row sums (14 x 98,815) and commit's (1 x
    98,815), each against its twin on the card, bit for bit, with the
    edge values in the first rows; one launch each."""
    dev = _cuda()
    dc.reset_launches()
    accel_nifs.row_sums.launches = 0
    w = t(rings(1, 1 << 15, 5, 19763)).to(dev)
    f = dc.gadget_decompose(w, 1 << 15, 5)
    assert torch.equal(f, torch.movedim(dc.decompose_balanced_twin(
        w, 1 << 15, 5), -1, -2).reshape(98815, 24))
    assert torch.equal(dc.gadget_recompose(f, 1 << 15, 5), w)
    fc = t(rings(2, 2, 15, 98815)).to(dev)
    ks = dc.decompose_vec_into_k_vecs(fc, 2, 15)
    assert torch.equal(ks, torch.movedim(dc.decompose_balanced_twin(
        fc, 2, 15), -1, 0))
    fb = t(rings(3, 1 << 15, 5, 15, 98815)).to(dev)
    got = dc.gadget_recompose(fb, 1 << 15, 5)
    assert torch.equal(got, dc.recompose_twin(
        fb.reshape(15, 19763, 5, 24), 1 << 15, -2))
    assert torch.equal(accel_nifs.row_sums(fb[1:]), gl.sum_axis(fb[1:], -2))
    assert torch.equal(accel_nifs.row_sums(fb[:1]), gl.sum_axis(fb[:1], -2))
    assert dc.decompose_balanced.launches == 2
    assert dc.recompose.launches == 2
    assert accel_nifs.row_sums.launches == 2


@pytest.mark.cuda
def test_cuda_kernels_ragged_shapes():
    """n = 1, 3, 2^k - 1, 2^k, 2^k + 1 rings, a leading batch dimension,
    every pair (b, L) of the tests above, digits last and along any axis;
    row sums around the 512 rows a block adds and the 16 x 24 threads."""
    dev = _cuda()
    for n in (1, 3, 255, 256, 257, 511, 512, 513, 4097):
        for b, L in GADGET + K_VECS:
            u = t(rings(n + L, b, L, 2, n)).to(dev)
            assert torch.equal(dc.gadget_decompose(u, b, L),
                               torch.movedim(dc.decompose_balanced_twin(
                                   u, b, L), -1, -2).reshape(2, n * L, 24))
            assert torch.equal(dc.decompose_vec_into_k_vecs(u, b, L),
                               torch.movedim(dc.decompose_balanced_twin(
                                   u, b, L), -1, 0))
            assert torch.equal(dc.decompose_balanced(u, b, L),
                               dc.decompose_balanced_twin(u, b, L))
            f = t(rings(n, b, L, 2, n * L)).to(dev)
            assert torch.equal(dc.gadget_recompose(f, b, L),
                               dc.recompose_twin(f.reshape(2, n, L, 24), b,
                                                 -2))
            for dim in (0, 1, 2):
                assert torch.equal(dc.recompose(f, b, dim),
                                   dc.recompose_twin(f, b, dim))
        for batch in (1, 2, 14):
            fs = t(rings(batch + n, 2, 1, batch, n)).to(dev)
            assert torch.equal(accel_nifs.row_sums(fs),
                               gl.sum_axis(fs, -2)), (batch, n)
    big = torch.full((1, 70000, 24), gl.P_I64 - 1, dtype=torch.int64,
                     device=dev)                   # rows of p - 1
    assert torch.equal(accel_nifs.row_sums(big), gl.sum_axis(big, -2))
    x = t(rings(5, 4, 8, 40)).to(dev)[::2]                 # not contiguous
    assert torch.equal(dc.gadget_decompose(x, 4, 8),
                       torch.movedim(dc.decompose_balanced_twin(
                           x, 4, 8), -1, -2).reshape(160, 24))
