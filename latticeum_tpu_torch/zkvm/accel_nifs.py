"""The NIFS fold step on the device with a host transcript.

Counterpart of ``latticeum_tpu/zkvm/accel_nifs.py::DeviceNifs`` on its main
path (t-layout, eq-factored rounds, row-constant Ajtai matrix).  Messages,
claims and the folded accumulator are bit-identical to the host path
``latticeum_tpu/nifs/nifs.py::prove``.

Witness tensors: w_ccs, f_coeff, f are (rows, 24) in standard layout; f_hat
is born in the t-layout (TAU, 24, npad) with a bit-reversed hypercube, so
the fold's f_hat tail is a plain concatenation.
"""

from __future__ import annotations

import time

import torch

from latticeum_tpu.field import host as H
from latticeum_tpu.nifs import decomposition as dec, folding as fold
from latticeum_tpu.nifs import linearization as lin, nifs as nifs_mod
from latticeum_tpu.nifs.structs import CCCS, LCCCS, TAU
from latticeum_tpu.zkvm.accel_rounds import lin_c_signs
from latticeum_tpu.zkvm.accel_t import bitrev_indices

from ..field import goldilocks as gl
from ..ring import decompose as dc, rq
from . import accel_rounds, claims, comb


def _brev(n):
    return torch.from_numpy(bitrev_indices((n - 1).bit_length() if n > 1
                                           else 0))


class TorchWitness:
    """Witness with device tensors (counterpart of DeviceWitness)."""

    def __init__(self, w_ccs, f_coeff, f, f_hat):
        self.w_ccs = w_ccs
        self.f_coeff = f_coeff
        self.f = f
        self.f_hat = f_hat


class TorchNifs:
    def __init__(self, engine, ccs, params, ajtai_rows):
        """ajtai_rows: host (kappa, 24) ints of the row-constant Ajtai
        matrix (commitment_scheme.rs:29-33 structure): cm_k = row_k * sum f."""
        self.e = engine
        self.ccs = ccs
        self.p = params
        dev = engine.device
        self.ajtai_rows = gl.from_int(ajtai_rows, dev)
        self._cap = engine.max_row + 1
        self._cap_pow2 = min(1 << (self._cap - 1).bit_length(), ccs.m)
        signs = lin_c_signs(ccs.c)
        self._lin_sets = (comb.lin_sets(ccs.S, signs, ccs.t, dev)
                          if signs is not None else None)
        brev_cap = _brev(self._cap_pow2)
        self._lin_row_pos = brev_cap.to(dev)[engine.rows]
        self._brev_cap = brev_cap.to(dev)
        self._fold_row_pos = _brev(ccs.m).to(dev)[engine.rows]

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
        pos = _brev(npad).to(f_coeff.device)[:nf]
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

    def _commit_totals(self, totals):
        """Row-constant Ajtai commitments of (..., 24) witness sums ->
        (..., kappa, 24)."""
        return rq.ntt_mul(self.ajtai_rows, totals[..., None, :])

    def commit(self, f):
        """Ajtai commitment of f (n, 24) -> host rings (kappa x 24 ints)."""
        return gl.to_int_lists(self._commit_totals(gl.sum_axis(f, -2)))

    # -- tables -------------------------------------------------------------
    def _eq_t(self, point, npad):
        """eq table of `point` with npad rows in the bit-reversed t-layout."""
        eq = self.e.eq_table(point, npad)
        return eq.T[:, _brev(eq.shape[0]).to(eq.device)]

    def eqT(self, point):
        """(t, n, 24) M_j^T eq(point) rows."""
        return self.e.mt_eq_stack(self.e.eq_table(point, self._cap))

    # -- linearization ------------------------------------------------------
    def lin_g_t(self, z, beta_s):
        """(t+1, 24, m') stack: each M_j z segment-summed straight into
        bit-reversed row positions, then the eq(beta) row; m' = cap rounded
        up to a power of two."""
        m = self._cap_pow2
        mz = self.e.mz_stack(z, m, self._lin_row_pos)        # (t, m, 24)
        eq = self.e.eq_table(beta_s, m)
        eqt = eq.T[:, self._brev_cap]
        return torch.cat([mz.transpose(1, 2), eqt[None]]).contiguous()

    def lin_prove(self, cm_i: CCCS, wit: TorchWitness, transcript, log=None):
        ccs = self.ccs
        beta_s = lin.squeeze_beta(transcript, ccs.s)
        head = self.e.ints([list(x) for x in cm_i.x_ccs]
                           + [H.ntt_from_u64(1)])
        z = torch.cat([head, wit.w_ccs])
        g = self.lin_g_t(z, beta_s)
        if self._lin_sets is None:
            raise ValueError("lin comb kernels need every c_i to be +-1")
        proof_sc, chals, final = accel_rounds.run_lin_rounds_factored(
            transcript, g, ccs.s, ccs.d + 1, self._lin_sets, beta_s, log=log)
        del g
        eq_r = self._eq_t(chals, wit.f_hat.shape[-1])
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
        p, ccs, dev = self.p, self.ccs, self.device
        point = [H.ntt_slots(r)[0] for r in cm_i.r]
        ks = dc.decompose_vec_into_k_vecs(wit.f_coeff, p.B_SMALL, p.K)
        f_b = rq.crt(ks)                                      # (K, nf, 24)
        w_b = dc.gadget_recompose(f_b, p.B, p.L)              # (K, nw, 24)
        fhat_b = self._fhat_t(ks)                             # (K, TAU, 24, npad)
        # row-constant commits for k >= 1; y_0 = cm - sum_k b^k y_k
        cms = self._commit_totals(gl.sum_axis(f_b[1:], -2))   # (K-1, kappa, 24)
        bp = gl.from_int([pow(p.B_SMALL, k, gl.P) for k in range(1, p.K)],
                         dev)
        y0 = gl.sub(self.e.ints([list(c) for c in cm_i.cm]),
                    gl.sum_axis(gl.mul(bp[:, None, None], cms), 0))
        y_s = gl.to_int_lists(torch.cat([y0[None], cms]))
        x_s = dec.compute_x_s(cm_i.x_w, cm_i.h, p)
        eq_r = self._eq_t(point, fhat_b.shape[-1])
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

        the challenged z per COO entry, segment-summed straight into
        bit-reversed rows."""
        ccs, e, dev = self.ccs, self.e, self.device
        K, m, t = self.p.K, ccs.m, ccs.t
        apows = []
        for a in alpha_s:
            pw = (1, 0, 0)
            for _d in range(TAU):
                pw = H.fq3_mul(pw, a)
                apows.append(pw)
        alpha = gl.from_int(apows, dev)                       # (2K*TAU, 3)
        zeta = gl.from_int([[H.fq3_pow(zeta_s[i], j + 1) for j in range(t)]
                            for i in range(2 * K)], dev)       # (2K, t, 3)

        def half(lo, hi):
            acc = None
            for idx in range(lo * TAU, hi * TAU):
                term = rq.ntt_scalar_mul_t(
                    tail[idx], tuple(alpha[idx, c] for c in range(3)))
                acc = term if acc is None else gl.add(acc, term)
            zg = None
            for i in range(lo, hi):
                zc = zeta[i][e.mats]                           # (nnz, 3)
                term = rq.ntt_scalar_mul(zs[i][e.cols],
                                         tuple(zc[:, c] for c in range(3)))
                zg = term if zg is None else gl.add(zg, term)
            mz = gl.segment_sum(e.coo_mul(zg), self._fold_row_pos, m)
            return gl.add(acc, mz.T)

        eqs = [self._eq_t(pt, m) for pt in eq_points]
        return torch.stack([eqs[0], half(0, K), eqs[1], half(K, 2 * K),
                            eqs[2]])

    def fold_prove(self, cm_i_s, transcript, batches, log=None):
        p, ccs, dev = self.p, self.ccs, self.device
        K, b_small = p.K, p.B_SMALL
        alpha_s, beta_s, zeta_s, mu_s = fold.squeeze_alpha_beta_zeta_mu(
            transcript, ccs.s, K)
        zs = torch.cat([b["z"] for b in batches])              # (2K, n, 24)
        fs = torch.cat([b["f"] for b in batches])              # (2K, nf, 24)
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
        f0 = None
        for i in range(2 * K):
            term = rq.ntt_mul(fs[i], rh[i][None])
            f0 = term if f0 is None else gl.add(f0, term)
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
        t = time.time()

        def mark(name):
            nonlocal t
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.time()
            if timings is not None:
                timings.setdefault(name, []).append(now - t)
            if log:
                log(f"  nifs.{name}: {now - t:.2f}s")
            t = now

        nifs_mod.sanity_check(self.ccs, self.p)
        nifs_mod.absorb_public_input(acc, cm_i, transcript)
        linearized, lin_proof, _ = self.lin_prove(cm_i, w_i, transcript,
                                                  log=log)
        mark("lin")
        lc_l, _, dp_l, b_l = self.dec_prove(acc, w_acc, transcript, log=log)
        mark("dec_l")
        lc_r, _, dp_r, b_r = self.dec_prove(linearized, w_i, transcript,
                                            log=log)
        mark("dec_r")
        folded, w0, fp = self.fold_prove(lc_l + lc_r, transcript, (b_l, b_r),
                                         log=log)
        mark("fold")
        proof = {"linearization": lin_proof, "decomposition_l": dp_l,
                 "decomposition_r": dp_r, "folding": fp}
        return folded, w0, proof
