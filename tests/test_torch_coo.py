"""The port's COO segment sums (``zkvm/accel.py``: ``build_csr``,
``coo_matvec``, ``coo_head``, kernels in ``csrc/coo.cu``) against the code
they replace and against the JAX package.

* The CSR wrappers' twin (what a CPU tensor runs) against
  ``goldilocks.segment_sum`` of the unsorted COO, the port's code before
  the CSR, on random COOs with empty segments and one segment of more
  than 700 entries, in both value kinds (base-field scalars, rings), the
  three output forms (standard, t-layout, the fold head's challenged z
  added in place); the heavy segments coo_kernel gives a block each.
* ``coo_head`` over both c rows at once against two one-row twin calls
  and against a Python-int sum (rows of p - 1, empty rows, a segment of
  more than 700 entries, 1 and 15 witnesses a row); a model of
  coo_head_kernel's partition (blocks of segments, runs of entries that
  cross segments, the pieces their owners add) on ragged CSRs.
* ``Engine.mz_stack``, ``Engine.mt_eq_stack`` and ``TorchNifs.lin_g_t``
  against JAX ``DeviceEngine.matvecs``, ``DeviceNifs.eqT`` and
  ``DeviceNifs.lin_g_t`` on XLA:CPU, on the test CCS (ring values) and
  on its scalar form (the zkVM's kind).
* On the card (``cuda`` marker): the kernels against their twin in every
  mode, heavy segments included, and coo_head on ragged and edge CSRs
  and on two streams at once.

Tolerance: none (exact integers)."""

import dataclasses
import importlib.util
import re
import types

import numpy as np
import pytest
import torch

from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.nifs.nifs import DecompositionParams
from latticeum_tpu.nifs.structs import SparseScalarMatrix
from latticeum_tpu.nifs.test_fixtures import (TEST_B, TEST_B_SMALL, TEST_K,
                                              TEST_L, get_test_ccs)
from latticeum_tpu.zkvm.accel_t import bitrev_indices
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.ring import rq
from latticeum_tpu_torch.zkvm import accel
from latticeum_tpu_torch.kernels import CSRC
from latticeum_tpu_torch.zkvm.accel import (Engine, build_csr, coo_head,
                                            coo_matvec, coo_out_shape)
from latticeum_tpu_torch.zkvm.accel_nifs import TorchNifs

P = gl.P
PARAMS = DecompositionParams(B=TEST_B, L=TEST_L, B_SMALL=TEST_B_SMALL,
                             K=TEST_K)
FORMS = ("standard", "t_layout", "head")


def rand_u64(rng, *shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def tt(u):
    return torch.from_numpy(gl.to_i64_bits(u))


def random_coo(rng, ring, n_mats=3, per=50, rows_in=40, heavy=705):
    """Entries over n_mats blocks of `per` segments: a few random ones
    (most segments stay empty), `heavy` into one segment and 30 into each
    of five others of the last block; values with p - 1 among them."""
    nseg = n_mats * per
    last = nseg - per
    seg = np.concatenate([rng.integers(0, nseg, nseg // 4),
                          np.full(heavy, last + 7),
                          np.repeat(np.arange(last + 20, last + 25), 30)])
    nnz = seg.shape[0]
    gather = rng.integers(0, rows_in, nnz)
    gather[:3] = rows_in - 1
    mats = seg // per
    vals = rand_u64(rng, nnz, 24) if ring else rand_u64(rng, nnz)
    vals[:5] = P - 1
    return seg, gather, mats, vals, nseg, per, rows_in


def old_segment_sums(seg, gather, mats, vals, nseg, x, zeta=None):
    """The port's code before the CSR: gather (the head's challenged z per
    entry), product, gl.segment_sum over the unsorted entries."""
    g = torch.from_numpy(gather)
    if zeta is None:
        y = x[g]
    else:
        y = None
        for i in range(x.shape[0]):
            zc = zeta[i][torch.from_numpy(mats)]
            term = rq.ntt_scalar_mul(x[i][g], tuple(zc[:, c]
                                                    for c in range(3)))
            y = term if y is None else gl.add(y, term)
    v = tt(vals)
    prod = gl.mul(v[:, None], y) if v.dim() == 1 else rq.ntt_mul(v, y)
    return gl.segment_sum(prod, torch.from_numpy(seg), nseg)


def coo_case(rng, ring, form, nwit=3):
    """(csr, x, zeta, out, t_layout, want) for one form; the head's x and
    zeta hold two c rows of nwit witnesses, its out and want are (2, 24,
    per)."""
    seg, gather, mats, vals, nseg, per, rows_in = random_coo(
        rng, ring, n_mats=1 if form == "head" else 3)
    csr = build_csr(seg, gather, mats, vals, nseg, per, "cpu",
                    head=form == "head")
    if form != "head":
        x = tt(rand_u64(rng, rows_in, 24))
        x.view(-1)[:24] = gl.P_I64 - 1
        s = old_segment_sums(seg, gather, mats, vals, nseg, x)
        s = s.reshape(-1, per, 24)
        if form == "standard":
            return csr, x, None, torch.empty_like(s), False, s
        s = s.transpose(1, 2).contiguous()
        return csr, x, None, torch.empty_like(s), True, s
    x = tt(rand_u64(rng, 2 * nwit, rows_in, 24))
    x.view(-1)[:24] = gl.P_I64 - 1
    zeta = tt(rand_u64(rng, 2 * nwit, 3, 3))
    zeta[0, 0] = zeta[-1, 2] = gl.P_I64 - 1
    base = tt(rand_u64(rng, 2, 24, per))
    want = torch.stack([gl.add(base[r], old_segment_sums(
        seg, gather, mats, vals, nseg, x[r * nwit:(r + 1) * nwit],
        zeta[r * nwit:(r + 1) * nwit]).t()) for r in range(2)])
    return csr, x, zeta, base.clone(), True, want


def run_form(csr, x, zeta, out, t_layout, twin=False):
    """The wrapper of the form (or its twin): coo_head into the two rows
    of `out` for the head, else coo_matvec.  Returns out."""
    if zeta is None:
        fn = accel.coo_matvec_twin if twin else coo_matvec
        return fn(csr, x, out, t_layout)
    fn = accel.coo_head_twin if twin else coo_head
    fn(csr, x, zeta, (out[0], out[1]))
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("ring", [False, True])
def test_csr_twin_matches_segment_sum(ring, form):
    rng = np.random.default_rng(3 + 2 * FORMS.index(form) + ring)
    csr, x, zeta, out, t_layout, want = coo_case(rng, ring, form)
    accel.coo_matvec.launches = accel.coo_head.launches = 0
    got = run_form(csr, x, zeta, out, t_layout)
    assert got is out
    assert torch.equal(out, want)
    assert accel.coo_matvec.launches == accel.coo_head.launches == 0
    counts = (csr.off[1:] - csr.off[:-1]).numpy()
    assert (counts == 0).sum() > csr.nseg // 2       # empty segments
    assert counts.max() > 700


@pytest.mark.parametrize("heavy", [accel.COO_LIGHT, 705])
def test_csr_heavy_segments_lead_the_size_order(heavy):
    """coo_kernel's heavy segments (entries > COO_LIGHT) are exactly the
    first n_heavy of full, whose sizes are the segments' entry counts,
    most first, every non-empty segment once; built for coo_head, full
    lists them in position order (a largest segment of COO_LIGHT entries
    is light, one of 705 heavy)."""
    rng = np.random.default_rng(5)
    seg, gather, mats, vals, nseg, per, _ = random_coo(rng, False,
                                                       heavy=heavy)
    csr = build_csr(seg, gather, mats, vals, nseg, per, "cpu")
    counts = np.bincount(seg, minlength=nseg)
    by = csr.full.numpy()
    assert sorted(by.tolist()) == np.flatnonzero(counts).tolist()
    assert np.array_equal(csr.sizes, counts[by])
    assert np.all(np.diff(csr.sizes) <= 0)
    k = csr.n_heavy()
    assert set(by[:k].tolist()) == set(
        np.flatnonzero(counts > accel.COO_LIGHT).tolist())
    assert (k > 0) == (heavy > accel.COO_LIGHT)
    off = np.concatenate([[0], np.cumsum(counts)])
    assert np.array_equal(csr.off.numpy(), off)
    assert csr.mats is None and csr.nz_off is None
    head = build_csr(seg, gather, mats, vals, nseg, per, "cpu", head=True)
    nz = np.flatnonzero(counts)
    assert np.array_equal(head.full.numpy(), nz)
    assert np.array_equal(head.sizes, counts[nz])
    assert np.array_equal(head.nz_off.numpy(), np.append(off[nz], off[-1]))
    assert np.array_equal(head.mats.numpy(), mats[np.argsort(seg,
                                                             kind="stable")])


def test_coo_matvec_validates_its_arguments():
    rng = np.random.default_rng(6)
    csr, x, zeta, out, t_layout, _ = coo_case(rng, False, "standard")
    with pytest.raises(ValueError):                  # output laid out wrong
        coo_matvec(csr, x, out, True)
    with pytest.raises(ValueError):                  # too few input rows
        coo_matvec(csr, x[:5].contiguous(), out, False)
    with pytest.raises(TypeError):
        coo_matvec(csr, x.to(torch.int32), out, False)
    with pytest.raises(ValueError):                  # not contiguous
        coo_matvec(csr, x.t().contiguous().t(), out, False)
    with pytest.raises(ValueError):
        build_csr(np.array([0, 5]), np.array([0, 0]), np.array([0, 0]),
                  np.array([1, 1], np.uint64), 4, 2, "cpu")
    head, *_ = coo_case(rng, False, "head")
    with pytest.raises(ValueError):                  # built for coo_head
        coo_matvec(head, x, torch.empty(coo_out_shape(head, True),
                                        dtype=torch.int64), True)


# -- the fold head's two c rows in one call ----------------------------------

HEAD_LANES = int(re.search(r"#define HEAD_LANES (\d+)",
                           (CSRC / "coo.cu").read_text()).group(1))


def head_coo(rng, ring, nseg=64, t=5, rows_in=40, heavy=705):
    """One block of `nseg` segments (the head's bit-reversed rows): a few
    random entries over random matrices (most segments stay empty, some
    of one entry), `heavy` into one segment, 1 ... 20 into a run of
    neighbours, the first and the last segment non-empty; values with
    p - 1 among them."""
    seg = np.concatenate([rng.integers(0, nseg, nseg // 4), [0, nseg - 1],
                          np.full(heavy, nseg // 2),
                          np.repeat(np.arange(5, 25), np.arange(1, 21))])
    nnz = seg.shape[0]
    gather = rng.integers(0, rows_in, nnz)
    gather[:3] = rows_in - 1
    mats = rng.integers(0, t, nnz)
    vals = rand_u64(rng, nnz, 24) if ring else rand_u64(rng, nnz)
    vals[:5] = P - 1
    return (build_csr(seg, gather, mats, vals, nseg, nseg, "cpu", head=True),
            rows_in, t)


def head_inputs(rng, csr, rows_in, t, k):
    """zs (2 k, rows_in, 24) with a row of p - 1, zeta (2 k, t, 3) with
    p - 1, outs: the two c rows, random (24, nseg) each."""
    zs = tt(rand_u64(rng, 2 * k, rows_in, 24))
    zs[0, rows_in - 1] = gl.P_I64 - 1
    zeta = tt(rand_u64(rng, 2 * k, t, 3))
    zeta[-1, 0] = gl.P_I64 - 1
    outs = [tt(rand_u64(rng, 24, csr.per)) for _ in range(2)]
    return zs, zeta, outs


def int_head_sums(csr, zs, zeta, outs):
    """The head sums in Python ints, Fq3 = F_p[Y] / (Y^3 - 2^40)."""
    w = 1 << 40

    def mul(a, b):
        c = [0] * 5
        for i in range(3):
            for j in range(3):
                c[i + j] += a[i] * b[j]
        return [(c[0] + w * c[3]) % P, (c[1] + w * c[4]) % P, c[2] % P]
    k = zs.shape[0] // 2
    off = csr.off.tolist()
    g, mt = csr.gather.tolist(), csr.mats.tolist()
    v = gl.to_u64(csr.vals).tolist()
    z, ze = gl.to_u64(zs).tolist(), gl.to_u64(zeta).tolist()
    res = []
    for r, out in enumerate(outs):
        o = gl.to_u64(out).astype(object)
        for s in range(csr.nseg):
            for e in range(off[s], off[s + 1]):
                for sl in range(8):
                    y = [0, 0, 0]
                    for i in range(r * k, (r + 1) * k):
                        p = mul(ze[i][mt[e]], z[i][g[e]][3 * sl:3 * sl + 3])
                        y = [(a + b) % P for a, b in zip(y, p)]
                    val = (v[e][3 * sl:3 * sl + 3] if isinstance(v[e], list)
                           else [v[e], 0, 0])
                    y = mul(val, y)
                    for c in range(3):
                        o[3 * sl + c, s] = (o[3 * sl + c, s] + y[c]) % P
        res.append(o)
    return res


@pytest.mark.parametrize("k", [1, 15])
@pytest.mark.parametrize("ring", [False, True])
def test_coo_head_matches_two_twin_calls_and_int_sum(ring, k):
    """coo_head over both c rows (witness i into row i // k) against the
    one-row twin called on each row and against the Python-int sum; rows
    without entries keep their values."""
    rng = np.random.default_rng(40 + 2 * k + ring)
    csr, rows_in, t = head_coo(rng, ring, heavy=705 if k == 1 else 120)
    zs, zeta, outs = head_inputs(rng, csr, rows_in, t, k)
    before = [o.clone() for o in outs]
    want = [o.clone() for o in outs]
    for r in range(2):
        accel.coo_matvec_twin(csr, zs[r * k:(r + 1) * k].contiguous(),
                              want[r], True,
                              zeta[r * k:(r + 1) * k].contiguous())
    accel.coo_head.launches = 0
    got = coo_head(csr, zs, zeta, outs)
    assert got is outs and accel.coo_head.launches == 0
    for r in range(2):
        assert torch.equal(outs[r], want[r])
    ints = int_head_sums(csr, zs, zeta, before)
    for r in range(2):
        assert np.array_equal(gl.to_u64(outs[r]).astype(object), ints[r])
    empty = (csr.off[1:] == csr.off[:-1]).numpy()
    assert empty.sum() > csr.nseg // 4 and csr.sizes.max() >= 120
    for r in range(2):
        assert torch.equal(outs[r][:, empty], before[r][:, empty])


def head_model(csr, zs, zeta, outs, grid, lanes):
    """coo_head_kernel's partition on the CPU, as csrc/coo.cu runs it: for
    each row, `grid` blocks take the segments whose first entry lies in
    [b nnz / grid, (b + 1) nnz / grid); a block's entries are cut into
    `lanes` runs of equal length (+-1) that cross segments; a run adds the
    segments that begin and end in it, keeps its first piece where the
    segment began earlier, and the run that began a segment going on past
    its end adds the later runs' pieces.  Each entry's sum over the row's
    witnesses times its value comes from the twin's arithmetic.  Checks
    that every entry is taken once and every non-empty segment written
    once; returns the outputs."""
    nz = csr.full.numpy()
    nz_off = csr.nz_off.numpy().astype(np.int64)
    begin, end = nz_off[:-1], nz_off[1:]     # of each non-empty segment
    n_nz, nnz = nz.size, int(nz_off[-1])
    k = zs.shape[0] // 2
    g, mats = csr.gather.long(), csr.mats.long()
    res = []
    for r, out in enumerate(outs):
        y = None
        for i in range(r * k, (r + 1) * k):
            term = rq.ntt_scalar_mul(zs[i][g], tuple(zeta[i][mats][:, c]
                                                     for c in range(3)))
            y = term if y is None else gl.add(y, term)
        prod = (gl.mul(csr.vals[:, None], y) if csr.vals.dim() == 1
                else rq.ntt_mul(csr.vals, y))
        out = out.clone()
        taken = np.zeros(nnz, int)
        written = np.zeros(n_nz, int)

        def write(kk, acc):
            out[:, nz[kk]] = gl.add(out[:, nz[kk]], acc)
            written[kk] += 1

        def first_at(lo, hi, e):
            return int(np.clip(np.searchsorted(nz_off, e, "left"), lo, hi))
        for b in range(grid):
            ka = first_at(0, n_nz, nnz * b // grid)
            kb = first_at(ka, n_nz, nnz * (b + 1) // grid)
            if ka == kb:
                continue
            ea, n_e = int(nz_off[ka]), int(nz_off[kb] - nz_off[ka])
            starts = [ea + n_e * j // lanes for j in range(lanes + 1)]
            pieces, tails = {}, []
            for lane in range(lanes):
                e0, e1 = starts[lane], starts[lane + 1]
                if e0 == e1:
                    continue
                kk = first_at(ka, kb, e0 + 1) - 1
                assert begin[kk] <= e0 < end[kk]
                is_open, first = begin[kk] < e0, True
                acc = torch.zeros(24, dtype=torch.int64)
                for e in range(e0, e1):
                    taken[e] += 1
                    acc = gl.add(acc, prod[e])
                    done = e + 1 == end[kk]
                    if not done and e + 1 < e1:
                        continue
                    if first and is_open:
                        pieces[lane] = acc
                    elif done:
                        write(kk, acc)
                    else:
                        tails.append((lane, kk, acc))
                    first, acc = False, torch.zeros(24, dtype=torch.int64)
                    if done:
                        kk += 1
            for lane, kk, acc in tails:
                for j in range(lane + 1, lanes):
                    if starts[j] >= end[kk]:
                        break
                    if starts[j + 1] > starts[j]:
                        acc = gl.add(acc, pieces.pop(j))
                write(kk, acc)
            assert not pieces                    # every piece was added
        assert np.all(taken == 1) and np.all(written == 1)
        res.append(out)
    return res


@pytest.mark.parametrize("grid,lanes", [(1, 1), (1, HEAD_LANES), (3, 4),
                                        (7, HEAD_LANES), (64, 5),
                                        (1000, HEAD_LANES), (5, 32),
                                        (5, 64)])
@pytest.mark.parametrize("ring", [False, True])
def test_coo_head_partition_model_matches_twin(ring, grid, lanes):
    """The kernel's partition, modelled, on ragged CSRs (a 705-entry
    segment split over many runs, runs shorter and longer than a segment,
    more blocks than segments, empty runs) gives the twin's sums; at the
    kernel's HEAD_LANES and at the run counts its design trials build
    (scripts/coo_head_trials.py: 32, 64)."""
    rng = np.random.default_rng(60 + grid + lanes + ring)
    csr, rows_in, t = head_coo(rng, ring)
    zs, zeta, outs = head_inputs(rng, csr, rows_in, t, 3)
    want = accel.coo_head_twin(csr, zs, zeta, [o.clone() for o in outs])
    got = head_model(csr, zs, zeta, outs, grid, lanes)
    for r in range(2):
        assert torch.equal(got[r], want[r])


def test_coo_head_validates_its_arguments():
    rng = np.random.default_rng(7)
    csr, rows_in, t = head_coo(rng, False, heavy=10)
    zs, zeta, outs = head_inputs(rng, csr, rows_in, t, 2)
    with pytest.raises(ValueError):                  # 3 rows
        coo_head(csr, zs[:3].contiguous(), zeta[:3].contiguous(),
                 outs + [outs[0].clone()])
    with pytest.raises(ValueError):                  # 1 row
        coo_head(csr, zs[:2].contiguous(), zeta[:2].contiguous(), outs[:1])
    with pytest.raises(ValueError):                  # 3 witnesses, 2 rows
        coo_head(csr, zs[:3].contiguous(), zeta[:3].contiguous(), outs)
    with pytest.raises(ValueError):                  # too few z rows
        coo_head(csr, zs[:, :5].contiguous(), zeta, outs)
    with pytest.raises(ValueError):                  # too few matrices
        coo_head(csr, zs, zeta[:, :1].contiguous(), outs)
    with pytest.raises(ValueError):                  # a row laid out wrong
        coo_head(csr, zs, zeta, [outs[0], outs[1].t().contiguous()])
    with pytest.raises(ValueError):                  # one row twice
        coo_head(csr, zs, zeta, [outs[0], outs[0]])
    with pytest.raises(TypeError):
        coo_head(csr, zs.to(torch.int32), zeta, outs)
    seg, gather, mats, vals, nseg, per, _ = random_coo(rng, False)
    with pytest.raises(ValueError):                  # three blocks
        coo_head(build_csr(seg, gather, mats, vals, nseg, per, "cpu",
                           head=True), zs, zeta, outs)
    seg, gather, mats, vals, nseg, _, _ = random_coo(rng, False, n_mats=1)
    with pytest.raises(ValueError):                  # built for coo_matvec
        coo_head(build_csr(seg, gather, mats, vals, nseg, nseg, "cpu"), zs,
                 zeta, outs)


def _coo_trials():
    spec = importlib.util.spec_from_file_location(
        "coo_head_trials", CSRC.parents[1] / "scripts" / "coo_head_trials.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COO_TRIALS = _coo_trials()


@pytest.mark.parametrize("name", list(COO_TRIALS.VARIANTS))
def test_coo_head_trials_variant_rewrites_coo_cu(name):
    """scripts/coo_head_trials.py builds each design variant from a copy of
    csrc/coo.cu: each constant it names is rewritten once and the others
    keep the kernel's values, each line rewrite finds its text, and the
    kernel's own variant is the source as it is."""
    src = (CSRC / "coo.cu").read_text()
    spec = COO_TRIALS.VARIANTS[name]
    out = COO_TRIALS.variant_source(src, spec)
    assert (out == src) == (not spec)
    for const in ("HEAD_LANES", "HEAD_GROUP", "HEAD_MIN_BLOCKS"):
        pattern = rf"^#define {const} (\d+)"
        (kernel,) = re.findall(pattern, src, flags=re.M)
        assert re.findall(pattern, out, flags=re.M) == [
            str(spec.get("defines", {}).get(const, kernel))]
    for _, new in spec.get("lines", ()):
        assert new in out


def test_coo_head_trials_rewrite_must_find_its_text():
    src = (CSRC / "coo.cu").read_text()
    with pytest.raises(RuntimeError):
        COO_TRIALS.variant_source(src, {"lines": [("no such line", "x")]})
    with pytest.raises(RuntimeError):
        COO_TRIALS.variant_source(src, {"defines": {"HEAD_NOTHING": 1}})


# -- the Engine's stacks against the JAX package ------------------------------

def scalar_ccs():
    """The test CCS with its ring values (c, 0, 0) x 8 held as base-field
    scalars c, the zkVM's kind of matrix."""
    ccs = get_test_ccs()
    mats = []
    for M in ccs.M:
        u = gl_ref.to_int((np.asarray(M.vals[0]), np.asarray(M.vals[1])))
        u = np.asarray(u, dtype=np.uint64)
        assert np.all(u[:, 1::3] == 0) and np.all(u[:, 2::3] == 0)
        assert np.all(u[:, 0::3] == u[:, :1])
        c = u[:, 0]
        mats.append(SparseScalarMatrix(
            M.nrows, M.ncols, M.rows, M.cols,
            ((c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (c >> np.uint64(32)).astype(np.uint32))))
    return dataclasses.replace(ccs, M=mats)


CCS_KINDS = {"ring": get_test_ccs, "scalar": scalar_ccs}


@pytest.fixture(scope="module")
def jax_side():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from latticeum_tpu.zkvm.accel import DeviceEngine
    from latticeum_tpu.zkvm.accel_nifs import DeviceNifs

    def make(ccs):
        e = DeviceEngine(ccs, PARAMS)
        return e, DeviceNifs(e, ccs, PARAMS, [[0] * 24] * 4, t_layout=True)
    return make


def u64(limbs):
    return np.asarray(gl_ref.to_int((np.asarray(limbs[0]),
                                     np.asarray(limbs[1])))).astype(np.uint64)


def port_nifs(ccs):
    scheme = types.SimpleNamespace(row_constant=True,
                                   rows_limbs=(np.zeros((4, 24), np.uint32),
                                               np.zeros((4, 24), np.uint32)))
    return TorchNifs(Engine(ccs, "cpu"), ccs, PARAMS, scheme)


def put(engine, x):
    u = gl.to_u64(x)
    return engine.put(((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (u >> np.uint64(32)).astype(np.uint32)))


@pytest.mark.parametrize("kind", list(CCS_KINDS))
def test_engine_stacks_match_jax(jax_side, kind):
    ccs = CCS_KINDS[kind]()
    je, jn = jax_side(ccs)
    dn = port_nifs(ccs)
    assert dn.e.scalar == (kind == "scalar")
    rng = np.random.default_rng(11)
    z = tt(rand_u64(rng, ccs.n, 24))
    z[0] = gl.P_I64 - 1
    point = [tuple(int(v) for v in rand_u64(rng, 3)) for _ in range(ccs.s)]
    beta = [tuple(int(v) for v in rand_u64(rng, 3)) for _ in range(ccs.s)]

    cap = dn.e.cap_pow2
    mz = dn.e.mz_stack(z)                                 # (t, 24, cap)
    brev = torch.from_numpy(bitrev_indices((cap - 1).bit_length()))
    want = u64(je.matvecs(put(je, z), cap))               # (t, cap, 24)
    assert np.array_equal(gl.to_u64(mz[..., brev].transpose(1, 2)), want)

    g = dn.lin_g_t(z, beta)
    assert np.array_equal(gl.to_u64(g), u64(jn.lin_g_t(put(je, z), beta)))

    assert np.array_equal(gl.to_u64(dn.eqT(point)), u64(jn.eqT(point)))


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def to_dev(csr, dev):
    return dataclasses.replace(csr, **{
        k: getattr(csr, k).to(dev)
        for k in ("off", "gather", "mats", "vals", "full", "nz_off")
        if getattr(csr, k) is not None})


@pytest.mark.cuda
def test_cuda_coo_matvec_matches_twin():
    """Every form and value kind, with 1 and 15 witnesses in the head form
    (coo_head), against the twin on the card."""
    dev = _cuda()
    rng = np.random.default_rng(31)
    accel.coo_matvec.launches = accel.coo_head.launches = 0
    calls = 0
    for ring in (False, True):
        for form in FORMS:
            for nwit in ((1, 15) if form == "head" else (1,)):
                csr, x, zeta, out, t_layout, _ = coo_case(
                    rng, ring, form, nwit)
                want = run_form(csr, x, zeta, out.clone(), t_layout, True)
                got = out.to(dev)
                run_form(to_dev(csr, dev), x.to(dev), None if zeta is None
                         else zeta.to(dev), got, t_layout)
                calls += 1
                assert torch.equal(got.cpu(), want), (ring, form, nwit)
    assert accel.coo_matvec.launches + accel.coo_head.launches == calls


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
def test_cuda_coo_head_matches_twin(ring):
    """coo_head on the card against the one-row twin on each row: ragged
    CSRs (a 705-entry segment, segments of 1 ... 20 entries, most empty),
    1, 3 and 15 witnesses a row, fewer non-empty segments than blocks,
    every input p - 1, and a head map of the
    production's size (2^17 segments, 68,000 entries over 125 matrices,
    15 witnesses a row)."""
    dev = _cuda()
    rng = np.random.default_rng(50 + ring)
    accel.coo_head.launches = 0
    cases = [(64, 705, 15), (64, 705, 1), (256, 120, 3), (8, 0, 15),
             (1024, 200, 15)]
    for nseg, heavy, k in cases:
        if heavy:
            csr, rows_in, t = head_coo(rng, ring, nseg=nseg, heavy=heavy)
        else:                                       # three segments
            csr = build_csr(np.array([0, 3, 3, 7]), np.array([0, 1, 2, 3]),
                            np.array([0, 1, 0, 1]),
                            rand_u64(rng, 4, 24) if ring else
                            rand_u64(rng, 4), nseg, nseg, "cpu", head=True)
            rows_in, t = 4, 2
        zs, zeta, outs = head_inputs(rng, csr, rows_in, t, k)
        if nseg == 1024:                            # every input p - 1
            zs.fill_(gl.P_I64 - 1)
            zeta.fill_(gl.P_I64 - 1)
            csr.vals.fill_(gl.P_I64 - 1)
        want = accel.coo_head_twin(csr, zs, zeta, [o.clone() for o in outs])
        got = coo_head(to_dev(csr, dev), zs.to(dev), zeta.to(dev),
                       [o.to(dev) for o in outs])
        for r in range(2):
            assert torch.equal(got[r].cpu(), want[r]), (nseg, heavy, k, r)
    # the production's size: 2^17 bit-reversed rows, 10,000 of them
    # non-empty, ~6.8 entries each, up to 53
    m, t, n, k = 1 << 17, 125, 19768, 15
    pos = rng.choice(m, 10000, replace=False)
    counts = rng.integers(3, 11, 10000)
    counts[:20] = 53
    seg = np.repeat(pos, counts)
    nnz = seg.size
    vals = rand_u64(rng, nnz, 24) if ring else rand_u64(rng, nnz)
    csr = build_csr(seg, rng.integers(0, n, nnz), rng.integers(0, t, nnz),
                    vals, m, m, "cpu", head=True)
    zs = tt(rand_u64(rng, 2 * k, n, 24)).to(dev)
    zeta = tt(rand_u64(rng, 2 * k, t, 3)).to(dev)
    head = tt(rand_u64(rng, 5, 24, m)).to(dev)
    want = head.clone()
    csr_d = to_dev(csr, dev)
    accel.coo_head_twin(csr_d, zs, zeta, (want[1], want[3]))
    coo_head(csr_d, zs, zeta, (head[1], head[3]))
    assert torch.equal(head, want)
    assert accel.coo_head.launches == len(cases) + 1


@pytest.mark.cuda
def test_cuda_coo_head_two_streams():
    """Two coo_head launches in flight on two streams, both waiting for
    one gate, eight times, each against its twin: no state crosses
    launches."""
    dev = _cuda()
    rng = np.random.default_rng(70)
    cases = []
    for ring in (False, True):
        csr, rows_in, t = head_coo(rng, ring, nseg=4096, heavy=300)
        zs, zeta, outs = head_inputs(rng, csr, rows_in, t, 15)
        want = accel.coo_head_twin(csr, zs, zeta, [o.clone() for o in outs])
        cases.append((to_dev(csr, dev), zs.to(dev), zeta.to(dev),
                      torch.stack(outs).to(dev), torch.stack(want)))
    streams = (torch.cuda.Stream(priority=0),
               torch.cuda.Stream(priority=-1))
    gate = torch.cuda.Stream()
    for rep in range(8):
        order = cases if rep % 2 == 0 else cases[::-1]
        outs = [c[3].clone() for c in order]
        torch.cuda.synchronize()
        with torch.cuda.stream(gate):
            torch.cuda._sleep(2_000_000)
        opened = torch.cuda.Event()
        opened.record(gate)
        for j, (stream, (csr, zs, zeta, _, _), out) in enumerate(
                zip(streams, order, outs)):
            with torch.cuda.stream(stream):
                stream.wait_event(opened)
                if j:
                    torch.cuda._sleep(60_000)
                coo_head(csr, zs, zeta, list(out))
        torch.cuda.synchronize()
        for (_, _, _, _, want), out in zip(order, outs):
            assert torch.equal(out.cpu(), want), rep
