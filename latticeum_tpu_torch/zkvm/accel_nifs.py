"""The NIFS fold step on the device with a host transcript.

Counterpart of ``latticeum_tpu/zkvm/accel_nifs.py::DeviceNifs`` on its main
path (t-layout, eq-factored rounds, evaluation claims as int8 digit-plane
products), with the row-constant Ajtai matrix or a general dense one.
Messages, claims and the folded accumulator are bit-identical to the host
path ``latticeum_tpu/nifs/nifs.py::prove``.

Witness tensors: w_ccs, f_coeff, f are (rows, 24) in standard layout; f_hat
is born in the t-layout (TAU, 24, npad) with a bit-reversed hypercube, so
the fold's f_hat tail is a plain concatenation.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl, mxu
from ..host.field import host as H
from ..host.nifs import decomposition as dec, folding as fold
from ..host.nifs import linearization as lin, nifs as nifs_mod
from ..host.nifs.structs import CCCS, LCCCS, TAU
from ..host.utils import tracing
from ..kernels import counted as _counted, launch as _launch, \
    ptr as _ptr, route as _route, stream as _stream
from ..ring import decompose as dc, rq
from . import accel_rounds, claims, comb, tables
from .tables import brev_on


# copied from latticeum_tpu/zkvm/accel_rounds.py:463
def lin_c_signs(c_rings):
    """If every lin comb constant is the +-1 scalar ring the zkvm builder
    emits ([s, 0, 0] x 8 slots with s in {1, p-1}), return the sign tuple
    for the lin comb kernels; else None (the kernels take the rings)."""
    signs = []
    for c in c_rings:
        vals = [int(v) % gl.P for v in c]
        if any(vals[i] != 0 for i in range(24) if i % 3 != 0):
            return None
        s0 = vals[0]
        if any(vals[i] != s0 for i in range(0, 24, 3)):
            return None
        if s0 == 1:
            signs.append(1)
        elif s0 == gl.P - 1:
            signs.append(-1)
        else:
            return None
    return tuple(signs)


def fq3_powers(x, n):
    """[x, x^2, ..., x^n] of a host Fq3 element, a running product: one
    multiply a power (the same values as H.fq3_pow)."""
    out, pw = [], (1, 0, 0)
    for _ in range(n):
        pw = H.fq3_mul(pw, x)
        out.append(pw)
    return out


# Rows a block of row_sums' first launch adds (32 words a thread).
ROW_SUMS_ROWS_PER_GROUP = 512


def row_sums(fs):
    """(B, n, 24) -> (B, 24): each witness's rows summed mod p.  On a card
    the kernel ``row_sums`` of ``csrc/decompose.cu`` (counterpart of
    ``latticeum_tpu/zkvm/accel_nifs.py:510`` ``gl.sum_axis(f[1:],
    axis=-2)``): blocks of ROW_SUMS_ROWS_PER_GROUP rows of each witness
    sum into a scratch tensor made for this call, and a second launch adds
    those partials, one reduction an output (counted once a call in
    ``row_sums.launches``); on the CPU its twin ``gl.sum_axis``."""
    if fs.dtype != gl.DTYPE:
        raise TypeError(f"row_sums: dtype {fs.dtype}, expected int64")
    if fs.dim() != 3 or fs.shape[-1] != rq.D:
        raise ValueError(f"row_sums: shape {tuple(fs.shape)}, expected "
                         f"(B, n, {rq.D})")
    if _route((fs,)) == "cpu":
        return gl.sum_axis(fs, -2)
    batch, n = fs.shape[0], fs.shape[1]
    if batch > 65535:
        raise ValueError(f"row_sums: {batch} witnesses, at most 65535")
    if not batch or not n:
        return torch.zeros((batch, rq.D), dtype=gl.DTYPE, device=fs.device)
    fs = fs.contiguous()
    groups = -(-n // ROW_SUMS_ROWS_PER_GROUP)
    partial = torch.empty((batch, groups, rq.D, 3), dtype=gl.DTYPE,
                          device=fs.device)
    out = torch.empty((batch, rq.D), dtype=gl.DTYPE, device=fs.device)
    _launch("lt_row_sums", _ptr(fs), _ptr(partial), _ptr(out), batch, n,
            groups, ROW_SUMS_ROWS_PER_GROUP, _stream())
    row_sums.launches += 1
    return out


row_sums.launches = 0
_counted(row_sums, "lt_row_sums")


def row_constant_commits(rows, fs):
    """The row-constant Ajtai commitments of the witnesses fs (B, n, 24),
    (B, kappa, 24): cm_b = rows * sum fs[b], rows (kappa, 24); the sums one
    call of row_sums, the products one launch of rq.ring_mul_each."""
    return rq.ring_mul_each(rows, row_sums(fs))


def recompose_y0(cm, cms, b_small):
    """dec's y_0 = cm - sum_{k >= 1} b^k cm_k, cms (K - 1, kappa, 24) the
    commitments cm_k, cm (kappa, 24): one launch of rq.ring_mac, each b^k
    as a scalar ring."""
    bp = gl.from_int([[pow(b_small, k, gl.P), 0, 0] * rq.N_SLOTS
                      for k in range(1, cms.shape[0] + 1)], cm.device)
    return rq.ring_mac((cms,), bp, base=cm)


class TorchWitness:
    """Witness with device tensors (counterpart of DeviceWitness)."""

    def __init__(self, w_ccs, f_coeff, f, f_hat):
        self.w_ccs = w_ccs
        self.f_coeff = f_coeff
        self.f = f
        self.f_hat = f_hat


AJTAI_CHUNK = 1 << 12


def matvec_general(mat, f):
    """Dense Ajtai matvec as chunked slot products (the JAX package's
    ``DeviceNifs._matvec_general``, accel_nifs.py:316): mat (kappa, N, 24),
    f (..., N, 24) -> (..., kappa, 24).  The plain reference of the
    digit-plane commit."""
    acc = None
    for start in range(0, mat.shape[-2], AJTAI_CHUNK):
        a = mat[:, start:start + AJTAI_CHUNK]                 # (kappa, c, 24)
        x = f[..., None, start:start + AJTAI_CHUNK, :]        # (..., 1, c, 24)
        part = gl.sum_axis(rq.ntt_mul(a, x), -2)
        acc = part if acc is None else gl.add(acc, part)
    return acc


class TorchNifs:
    def __init__(self, engine, ccs, params, scheme):
        """`scheme`: the host ``AjtaiScheme``.  A row-constant one
        (commitment_scheme.rs:29-33 structure) keeps its (kappa, 24) rows
        and commits cm_k = row_k * sum f.  Of any other, (kappa, N, 24),
        only the digit planes are kept on the device, split once here;
        every commitment is then a digit-plane contraction against them
        (``mxu.contract``)."""
        self.e = engine
        self.ccs = ccs
        self.p = params
        dev = engine.device
        self.general_ajtai = not getattr(scheme, "row_constant", False)
        self.ajtai_rows = self._ajtai_planes = None
        if self.general_ajtai:
            self._ajtai_planes = mxu.digit_split(
                gl.from_limbs(scheme.matrix, dev))
        else:
            self.ajtai_rows = gl.from_limbs(scheme.rows_limbs, dev)
        self._cap = engine.max_row + 1
        self._cap_pow2 = engine.cap_pow2
        signs = lin_c_signs(ccs.c)
        self._lin_sets = (comb.lin_sets(ccs.S, signs, ccs.t, dev)
                          if signs is not None else
                          comb.lin_sets_general(ccs.S, ccs.c, ccs.t, dev))

    @property
    def device(self):
        return self.e.device

    # -- witness pipeline -------------------------------------------------
    def _fhat_t(self, f_coeff):
        """(..., nf, 24) coefficient form -> (..., TAU, 24, npad) t-layout,
        bit-reversed: slot s of f_hat[j][i] is (f_coeff[i][8j+s], 0, 0)."""
        lead = f_coeff.shape[:-2]
        nf = f_coeff.shape[-2]
        npad = 1 << (nf - 1).bit_length() if nf > 1 else 1
        out = torch.zeros(lead + (TAU, 8, 3, npad), dtype=gl.DTYPE,
                          device=f_coeff.device)
        vals = torch.movedim(f_coeff.reshape(lead + (nf, TAU, 8)), -3, -1)
        pos = brev_on(npad, f_coeff.device)[:nf]
        out[..., 0, pos] = vals
        return out.reshape(lead + (TAU, 24, npad))

    def build_witness(self, w):
        """w_ccs (nw, 24) -> TorchWitness."""
        f_coeff = dc.gadget_decompose(rq.icrt(w), self.p.B, self.p.L)
        return TorchWitness(w, f_coeff, rq.crt(f_coeff), self._fhat_t(f_coeff))

    def witness_from_f_coeff(self, f_coeff):
        f = rq.crt(f_coeff)
        return TorchWitness(dc.gadget_recompose(f, self.p.B, self.p.L),
                            f_coeff, f, self._fhat_t(f_coeff))

    def witness_from_f(self, f):
        f_coeff = rq.icrt(f)
        return TorchWitness(dc.gadget_recompose(f, self.p.B, self.p.L),
                            f_coeff, f, self._fhat_t(f_coeff))

    def _commit_many(self, fs):
        """Ajtai commitments of the witnesses fs (B, n, 24) ->
        (B, kappa, 24): the row-constant shortcut on their sums, or the
        dense matvec as one digit-plane contraction."""
        if self.general_ajtai:
            return mxu.contract(self._ajtai_planes,
                                mxu.digit_split(fs)).transpose(0, 1)
        return row_constant_commits(self.ajtai_rows, fs)

    def commit(self, f):
        """Ajtai commitment of f (n, 24) -> host rings (kappa x 24 ints)."""
        return gl.to_int_lists(self._commit_many(f[None])[0])

    # -- tables -------------------------------------------------------------
    def eqT(self, point):
        """(t, n, 24) M_j^T eq(point) rows."""
        return self.e.mt_eq_stack(self.e.eq_table(point, self._cap))

    # -- linearization ------------------------------------------------------
    def lin_g_t(self, z, beta_s):
        """(t+1, 24, m') stack: each M_j z segment-summed straight into
        bit-reversed row positions, then the eq(beta) row; m' = cap rounded
        up to a power of two.  Both written in place by their kernels."""
        m, t = self._cap_pow2, self.ccs.t
        g = torch.empty((t + 1, 24, m), dtype=gl.DTYPE, device=self.device)
        self.e.mz_stack(z, out=g[:t])
        self.e.eq_table(beta_s, m, t_layout=True, out=g[t])
        return g

    def lin_prove(self, cm_i: CCCS, wit: TorchWitness, transcript, log=None):
        ccs = self.ccs
        beta_s = lin.squeeze_beta(transcript, ccs.s)
        head = self.e.ints([list(x) for x in cm_i.x_ccs]
                           + [H.ntt_from_u64(1)])
        z = torch.cat([head, wit.w_ccs])
        g = self.lin_g_t(z, beta_s)
        proof_sc, chals, final = accel_rounds.run_lin_rounds_factored(
            transcript, g, ccs.s, ccs.d + 1, self._lin_sets, beta_s, log=log)
        del g
        eq_r = self.e.eq_table(chals, wit.f_hat.shape[-1],
                               t_layout=True)
        v = gl.to_int_lists(claims.eval_fhat(wit.f_hat, eq_r))
        u = gl.to_int_lists(final[:ccs.t])
        transcript.absorb_slice(v)
        transcript.absorb_slice(u)
        proof = {"sumcheck": proof_sc, "v": v, "u": u}
        lcccs = LCCCS(r=[H.ntt_from_fq3(r) for r in chals], v=v,
                      cm=[list(x) for x in cm_i.cm], u=u,
                      x_w=[list(x) for x in cm_i.x_ccs], h=H.ntt_from_u64(1))
        return lcccs, proof, z

    # -- decomposition --------------------------------------------------------
    def dec_prove(self, cm_i: LCCCS, wit: TorchWitness, transcript, log=None):
        p = self.p
        point = [H.ntt_slots(r)[0] for r in cm_i.r]
        ks = dc.decompose_vec_into_k_vecs(wit.f_coeff, p.B_SMALL, p.K)
        f_b = rq.crt(ks)                                      # (K, nf, 24)
        w_b = dc.gadget_recompose(f_b, p.B, p.L)              # (K, nw, 24)
        fhat_b = self._fhat_t(ks)                             # (K, TAU, 24, npad)
        # commits for k >= 1; y_0 = cm - sum_k b^k y_k
        cms = self._commit_many(f_b[1:])                      # (K-1, kappa, 24)
        y0 = recompose_y0(self.e.ints([list(c) for c in cm_i.cm]), cms,
                          p.B_SMALL)
        y_s = gl.to_int_lists(torch.cat([y0[None], cms]))
        with tracing.span("nifs.dec.compute_x_s"):
            x_s = dec.compute_x_s(cm_i.x_w, cm_i.h, p)
        eq_r = self.e.eq_table(point, fhat_b.shape[-1],
                               t_layout=True)
        v_s = gl.to_int_lists(claims.eval_fhat(fhat_b, eq_r))
        heads = self.e.ints([[list(v) for v in x_s[k]] for k in range(p.K)])
        z_b = torch.cat([heads, w_b], dim=1)                  # (K, n, 24)
        u_s = gl.to_int_lists(claims.eval_claims(self.eqT(point), z_b))
        lcccs_s = []
        for k in range(p.K):
            transcript.absorb_slice(x_s[k])
            transcript.absorb_slice(y_s[k])
            transcript.absorb_slice(u_s[k])
            transcript.absorb_slice(v_s[k])
            lcccs_s.append(LCCCS(r=[list(r) for r in cm_i.r], v=v_s[k],
                                 cm=y_s[k], u=u_s[k], x_w=x_s[k][:-1],
                                 h=x_s[k][-1]))
        wit_s = [TorchWitness(w_b[k], ks[k], f_b[k], fhat_b[k])
                 for k in range(p.K)]
        proof = {"u_s": u_s, "v_s": v_s, "x_s": x_s, "y_s": y_s}
        batch = {"f": f_b, "fhat": fhat_b, "z": z_b}
        return lcccs_s, wit_s, proof, batch

    # -- folding --------------------------------------------------------------
    def _build_head(self, tail, zs, alpha_s, zeta_s, eq_points):
        """The 5-row fold head [eq_r1, c1, eq_r2, c2, eq_beta], (5, 24, m):

          c_half = sum_{i,d} alpha_i^{d+1} f_hat[i][d]
                   + sum_j M_j (sum_i zeta_i^{j+1} z_i)

        the eq rows and the alpha-sums written in place by their kernels
        (``tables``), then the challenged z per COO entry, segment-summed
        straight into bit-reversed rows, added to both c rows by one
        ``coo_head`` (``Engine.mz_challenged``)."""
        ccs, e, dev = self.ccs, self.e, self.device
        K, m, t = self.p.K, ccs.m, ccs.t
        alpha = gl.upload(gl.from_int(
            [pw for a in alpha_s for pw in fq3_powers(a, TAU)]),
            dev)                                               # (2K*TAU, 3)
        zeta = gl.upload(gl.from_int(
            [fq3_powers(zeta_s[i], t) for i in range(2 * K)]),
            dev)                                               # (2K, t, 3)
        head = torch.empty((5, 24, m), dtype=gl.DTYPE, device=dev)
        for row, pt in zip((0, 2, 4), eq_points):
            e.eq_table(pt, m, t_layout=True, out=head[row])
        tables.head_alpha(tail, alpha, head[1], head[3])
        e.mz_challenged(zs, zeta, (head[1], head[3]))
        return head

    def fold_prove(self, cm_i_s, transcript, batches, log=None):
        p, ccs, dev = self.p, self.ccs, self.device
        K, b_small = p.K, p.B_SMALL
        alpha_s, beta_s, zeta_s, mu_s = fold.squeeze_alpha_beta_zeta_mu(
            transcript, ccs.s, K)
        zs = torch.cat([b["z"] for b in batches])              # (2K, n, 24)
        tail = torch.cat([b["fhat"] for b in batches]).reshape(
            2 * K * TAU, 24, ccs.m)
        for b in batches:
            b["fhat"] = None          # the tail holds the only live copy
        r1 = [H.ntt_slots(r)[0] for r in cm_i_s[0].r]
        r2 = [H.ntt_slots(r)[0] for r in cm_i_s[K].r]
        head = self._build_head(tail, zs, alpha_s, zeta_s, (r1, r2, beta_s))
        proof_sc, r_0, final = accel_rounds.run_fold_rounds_factored(
            transcript, head, tail, ccs.s, 2 * b_small, mu_s,
            (r1, r2, beta_s), b_small, K, log=log)
        del head, tail
        # theta_s = mle[f_hat](r_0): rows 5.. of the sum-check's finals
        theta_flat = gl.to_int_lists(final[5:])
        theta_s = [theta_flat[i * TAU:(i + 1) * TAU] for i in range(2 * K)]
        eta_s = gl.to_int_lists(claims.eval_claims(self.eqT(r_0), zs))
        for th in theta_s:
            transcript.absorb_slice(th)
        for et in eta_s:
            transcript.absorb_slice(et)
        rho_coeff, rho_ntt = fold.get_rhos(transcript, K)
        rh = gl.from_int(rho_ntt, dev)                          # (2K, 24)
        # f0 = sum_i rho_i f_i over both batches' f where they lie
        f0 = rq.ring_mac([b["f"] for b in batches], rh)
        v_0, cm_0, u_0, x_0 = fold.compute_v0_u0_x0_cm0_vec(
            rho_coeff, rho_ntt, theta_s, cm_i_s, eta_s, ccs)
        lcccs = LCCCS(r=[H.ntt_from_fq3(c) for c in r_0], v=v_0, cm=cm_0,
                      u=u_0, x_w=x_0[:-1], h=x_0[-1])
        w_0 = self.witness_from_f(f0)
        proof = {"sumcheck": proof_sc, "theta_s": theta_s, "eta_s": eta_s}
        return lcccs, w_0, proof

    # -- composition ------------------------------------------------------------
    def prove(self, acc, w_acc: TorchWitness, cm_i, w_i: TorchWitness,
              transcript, log=None, timings=None):
        """The fold step; each phase a span that waits for the device as
        it closes and appends its seconds to timings[phase] (lin, dec_l,
        dec_r, fold)."""
        dev = self.device
        wait = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else None)

        def phase(name):
            return tracing.span("nifs." + name, timings, name, wait, log)

        with phase("lin"):
            nifs_mod.sanity_check(self.ccs, self.p)
            nifs_mod.absorb_public_input(acc, cm_i, transcript)
            linearized, lin_proof, _ = self.lin_prove(cm_i, w_i, transcript,
                                                      log=log)
        with phase("dec_l"):
            lc_l, _, dp_l, b_l = self.dec_prove(acc, w_acc, transcript,
                                                log=log)
        with phase("dec_r"):
            lc_r, _, dp_r, b_r = self.dec_prove(linearized, w_i, transcript,
                                                log=log)
        with phase("fold"):
            folded, w0, fp = self.fold_prove(lc_l + lc_r, transcript,
                                             (b_l, b_r), log=log)
        proof = {"linearization": lin_proof, "decomposition_l": dp_l,
                 "decomposition_r": dp_r, "folding": fp}
        return folded, w0, proof
