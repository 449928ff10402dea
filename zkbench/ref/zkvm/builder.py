"""CCS gate builder: 125 sparse matrices / 52 multisets over the zkVM layout.

Faithful port of the reference's CCSBuilder (latticeum/crates/zkvm/src/
constraints.rs:73-1830): Poseidon2 in-circuit gates (step-inverse, initial
MDS, external/internal rounds via the pinned inverse matrices, result hash),
RISC-V gates (pc/add/jal/jalr/bne/auipc/lui), and the folding-proof verifier
gates (linearization sum-check transcript re-check, decomposition
recomposition, claim g1/g3 Horner chains, folding sum-check, PoC evaluation
shortcut, final cm/u/x rho-combinations).  All matrix coefficients are
scalar ring elements, so matrices are stored scalar-sparse.

Known reference quirks replicated for parity: the after-initial-MDS gate
only constrains sponge pass 1 (constraints.rs:205-246 `i <
WIDE_POSEIDON2_WIDTH` is always true); ADDI/SW selectors exist but have no
gates; the folding evaluation check is the PoC shortcut.
"""

from __future__ import annotations

from ..crypto import consts as p2c
from ..field import host as H
from ..nifs.structs import CCS, SparseScalarMatrix
from .params import (CCS_C, CCS_NUM_MATRICES, FULL_ROUNDS, PARTIAL_ROUNDS,
                     P2_OUT, P2_WIDTH, SBOX_DEGREE, SPONGE_PASSES, ZkVmParams)

P = H.P


class RowIndex:
    """Constraint row index constants (constraints.rs:1735-1808)."""

    def __init__(self, p: ZkVmParams):
        s = p.ccs_s
        K, KAPPA, TAU = p.K, p.KAPPA, p.TAU
        XW = 4
        cur = 0

        def one():
            nonlocal cur
            v = cur
            cur += 1
            return v

        def arr(n):
            nonlocal cur
            v = list(range(cur, cur + n))
            cur += n
            return v

        self.ADD = one()
        self.PC_NON_BRANCH = one()
        self.JAL = one()
        self.JALR = one()
        self.BNE = one()
        self.AUIPC = one()
        self.LUI = one()
        self.IVC_STEP = one()
        self.AFTER_MDS = arr(SPONGE_PASSES * P2_WIDTH)
        self.EXT_INIT = arr(FULL_ROUNDS * P2_WIDTH)
        self.INTERNAL = arr(SPONGE_PASSES * PARTIAL_ROUNDS * P2_WIDTH)
        self.EXT_TERM = arr(FULL_ROUNDS * P2_WIDTH)
        self.HASH = arr(P2_OUT)
        self.LIN_INITIAL_CLAIM_ZERO = one()
        self.LIN_CLAIMED_SUM_EQUALS = arr(s)
        self.LIN_CLAIMED_SUM_SUBTERMS = arr(s)
        self.LIN_FINAL_CLAIMED_SUM = one()
        self.LIN_E_XI_YI = arr(s)
        self.LIN_E_FACTORS = arr(s)
        self.LIN_E_SUB_RES = arr(s + 1)
        self.LIN_INNER_EVAL = one()
        self.LIN_INNER_PRODS_PER_MULTISET = arr(CCS_C)
        self.LIN_INNER_DECOMP = one()
        self.DECOMP_CM = arr(KAPPA)
        self.DECOMP_V = arr(TAU)
        self.DECOMP_U = arr(CCS_NUM_MATRICES)
        self.DECOMP_XW = arr(XW)
        self.DECOMP_H = one()
        self.DECOMP_R_CM = arr(KAPPA)
        self.DECOMP_R_V = arr(TAU)
        self.DECOMP_R_U = arr(CCS_NUM_MATRICES)
        self.DECOMP_R_XW = arr(XW)
        self.DECOMP_R_H = one()
        self.G1_H1 = arr(2 * K)
        self.G1_H2 = arr(2 * K)
        self.G1_TERM = arr(2 * K)
        self.G1_SUM = one()
        self.G3_STEP = arr(2 * K * (CCS_NUM_MATRICES - 1))
        self.G3_TERM = arr(2 * K)
        self.G3_SUM = one()
        self.FOLD_SC_INITIAL = one()
        self.FOLD_SC_CLAIM_EQ = arr(s)
        self.FOLD_SC_CLAIM_SUB = arr(s)
        self.FOLD_SC_FINAL = one()
        self.FOLD_EXPECTED = one()
        self.FINAL_CM_PRODUCTS = arr(2 * K * KAPPA)
        self.FINAL_CM_EQ = arr(KAPPA)
        self.FINAL_U_PRODUCTS = arr(2 * K * CCS_NUM_MATRICES)
        self.FINAL_U_EQ = arr(CCS_NUM_MATRICES)
        self.FINAL_X_PRODUCTS = arr(2 * K * (XW + 1))
        self.FINAL_XW_EQ = arr(XW)
        self.FINAL_H_EQ = one()
        self.total_rows = cur


NEG1 = P - 1


class CCSBuilder:
    def __init__(self, layout, W: int):
        self.m = W
        self.lay = layout
        self.p = layout.params
        self.R = RowIndex(self.p)
        self.mats: list[list] = []       # each: list[(row, col, coeff_int)]
        self.multisets: list[list] = []
        self.coeffs: list[int] = []      # scalar coefficients mod p

    # -- helpers ----------------------------------------------------------
    def new_mat(self):
        self.mats.append([])
        return len(self.mats) - 1

    def push(self, midx, row, coeff, col):
        self.mats[midx].append((row, col, coeff % P))

    def gate(self, matrix_indices, coeff):
        self.multisets.append(list(matrix_indices))
        self.coeffs.append(coeff % P)

    # -- ivc / poseidon2 gates -------------------------------------------
    def ivc_step_inv(self):
        lay, R = self.lay, self.R
        base = len(self.mats)
        for _ in range(3):
            m = self.new_mat()
        # matrices base..base+2: step, step, step_inv
        self.push(base, R.IVC_STEP, 1, lay.ivc_h_i_step_idx)
        self.push(base + 1, R.IVC_STEP, 1, lay.ivc_h_i_step_idx)
        self.push(base + 2, R.IVC_STEP, 1, lay.ivc_h_i_step_inv_idx)
        self.gate([base, base + 1, base + 2], 1)
        m = self.new_mat()
        self.push(m, R.IVC_STEP, 1, lay.ivc_h_i_step_idx)
        self.gate([m], NEG1)

    def _mds_row_coeffs(self, i):
        """Row i of the width-16 external matrix (constraints.rs:204-226)."""
        m4 = p2c.M4[i % 4]
        row = (m4 * 4)[:P2_WIDTH]
        row = list(row)
        dg = (i // 4) * 4
        for j in range(4):
            row[dg + j] *= 2
        return row

    def ivc_after_initial_mds(self):
        lay, R = self.lay, self.R
        midx = self.new_mat()
        pass1 = ([lay.ivc_h_i_step_idx] + lay.ivc_h_i_state_0_comm_idx
                 + lay.ivc_h_i_state_i_comm_idx
                 + lay.ivc_h_i_acc_i_comm_idx[:3])
        # NOTE: the reference only emits pass-1 rows here
        # (constraints.rs:205-246: `if i < WIDE_POSEIDON2_WIDTH` always true).
        for i in range(P2_WIDTH):
            row = R.AFTER_MDS[i]
            coeffs = self._mds_row_coeffs(i)
            self.push(midx, row, 1, lay.ivc_h_i_after_mds_idx[i])
            for k in range(len(pass1)):
                self.push(midx, row, -coeffs[k], pass1[k])
        self.gate([midx], 1)

    def _external_rounds(self, rows, state_in_round0, out_idx, consts_rounds):
        """Shared shape of ext-initial / ext-terminal gates.

        rows: row indices (passes*rounds*width);
        state_in_round0(pass) -> list of 16 z-indices feeding round 0;
        out_idx: layout array holding the round outputs
                 (passes*rounds*width, pass-major);
        consts_rounds: per-round 16 round constants.
        """
        lay, R = self.lay, self.R
        nrounds = FULL_ROUNDS // 2
        base7 = len(self.mats)
        for _ in range(SBOX_DEGREE):
            m = self.new_mat()
            for pas in range(SPONGE_PASSES):
                off = pas * nrounds * P2_WIDTH
                src = state_in_round0(pas)
                for i in range(P2_WIDTH):
                    self.push(m, rows[off + i], 1, src[i])
                    self.push(m, rows[off + i], consts_rounds[0][i],
                              lay.const_1_idx)
            for rnd in range(1, nrounds):
                prev = (rnd - 1) * P2_WIDTH
                cur = rnd * P2_WIDTH
                for pas in range(SPONGE_PASSES):
                    off = pas * nrounds * P2_WIDTH
                    for i in range(P2_WIDTH):
                        self.push(m, rows[off + cur + i], 1,
                                  out_idx[off + prev + i])
                        self.push(m, rows[off + cur + i],
                                  consts_rounds[rnd][i], lay.const_1_idx)
        self.gate(list(range(base7, base7 + SBOX_DEGREE)), NEG1)

        inv_idx = self.new_mat()
        for rnd in range(nrounds):
            cur = rnd * P2_WIDTH
            for pas in range(SPONGE_PASSES):
                off = pas * nrounds * P2_WIDTH
                for i in range(P2_WIDTH):
                    for k, coeff in enumerate(p2c.MDS_INVERSE_TRANSPOSED[i]):
                        self.push(inv_idx, rows[off + cur + i], coeff,
                                  out_idx[off + cur + k])
        ones = []
        for _ in range(SBOX_DEGREE - 1):
            m = self.new_mat()
            for i in range(SPONGE_PASSES * nrounds * P2_WIDTH):
                self.push(m, rows[i], 1, lay.const_1_idx)
            ones.append(m)
        self.gate([inv_idx] + ones, 1)

    def ivc_external_initial(self):
        lay = self.lay
        self._external_rounds(
            self.R.EXT_INIT,
            lambda pas: lay.ivc_h_i_after_mds_idx[pas * P2_WIDTH:
                                                  (pas + 1) * P2_WIDTH],
            lay.ivc_h_i_external_initial,
            p2c.W16_EXTERNAL_INITIAL)

    def _last_ext_init(self, pas):
        lay = self.lay
        nrounds = FULL_ROUNDS // 2
        off = pas * nrounds * P2_WIDTH
        start = off + (nrounds - 1) * P2_WIDTH
        return lay.ivc_h_i_external_initial[start:start + P2_WIDTH]

    def ivc_internal_rounds(self):
        lay, R = self.lay, self.R
        nrounds = PARTIAL_ROUNDS
        base7 = len(self.mats)
        for _ in range(SBOX_DEGREE):
            m = self.new_mat()
            for rnd in range(nrounds):
                const = p2c.INTERNAL_22[rnd]
                for pas in range(SPONGE_PASSES):
                    off = pas * nrounds * P2_WIDTH
                    row = R.INTERNAL[off + rnd * P2_WIDTH]
                    if rnd == 0:
                        self.push(m, row, 1, self._last_ext_init(pas)[0])
                    else:
                        prev = off + (rnd - 1) * P2_WIDTH
                        self.push(m, row, 1,
                                  lay.ivc_h_i_after_internal_idx[prev])
                    self.push(m, row, const, lay.const_1_idx)
        self.gate(list(range(base7, base7 + SBOX_DEGREE)), NEG1)

        inv = self.new_mat()
        for rnd in range(nrounds):
            for pas in range(SPONGE_PASSES):
                off = pas * nrounds * P2_WIDTH
                cur = rnd * P2_WIDTH
                for i in range(P2_WIDTH):
                    row = R.INTERNAL[off + cur + i]
                    for k, coeff in enumerate(p2c.M_I_INVERSE_TRANSPOSED[i]):
                        self.push(inv, row, coeff,
                                  lay.ivc_h_i_after_internal_idx[off + cur + k])
                    if i != 0:
                        if rnd == 0:
                            # NOTE reference indexes after_ext_init_idx
                            # [round_idx_offset + i] == [i] for round 0
                            self.push(inv, row, NEG1,
                                      self._last_ext_init(pas)[i])
                        else:
                            prev = (rnd - 1) * P2_WIDTH
                            self.push(inv, row, NEG1,
                                      lay.ivc_h_i_after_internal_idx[
                                          off + prev + i])
        ones = []
        for _ in range(SBOX_DEGREE - 1):
            m = self.new_mat()
            for i in range(SPONGE_PASSES * nrounds * P2_WIDTH):
                self.push(m, R.INTERNAL[i], 1, self.lay.const_1_idx)
            ones.append(m)
        self.gate([inv] + ones, 1)

    def _last_internal(self, pas):
        lay = self.lay
        if pas == 0:
            start = (PARTIAL_ROUNDS - 1) * P2_WIDTH
        else:
            start = (SPONGE_PASSES * PARTIAL_ROUNDS - 1) * P2_WIDTH
        return lay.ivc_h_i_after_internal_idx[start:start + P2_WIDTH]

    def ivc_external_terminal(self):
        lay = self.lay
        self._external_rounds(
            self.R.EXT_TERM,
            lambda pas: self._last_internal(pas),
            lay.ivc_h_i_external_terminal,
            p2c.W16_EXTERNAL_TERMINAL)

    def ivc_result_hash(self):
        lay, R = self.lay, self.R
        start = (FULL_ROUNDS - 1) * P2_WIDTH
        last = lay.ivc_h_i_external_terminal[start:start + P2_WIDTH]
        m = self.new_mat()
        for i in range(P2_OUT):
            self.push(m, R.HASH[i], 1, lay.ivc_h_i_idx[i])
            self.push(m, R.HASH[i], NEG1, last[i])
        self.gate([m], 1)

    # -- risc-v gates -----------------------------------------------------
    def _selector_gate(self, row, sel_idx, b_terms):
        base = len(self.mats)
        ma = self.new_mat()
        self.push(ma, row, 1, sel_idx)
        mb = self.new_mat()
        for coeff, col in b_terms:
            self.push(mb, row, coeff, col)
        self.gate([base, base + 1], 1)

    def pc_non_branching(self):
        lay, R = self.lay, self.R
        base = len(self.mats)
        ma = self.new_mat()
        self.push(ma, R.PC_NON_BRANCH, 1, lay.const_1_idx)
        self.push(ma, R.PC_NON_BRANCH, NEG1, lay.is_branching_idx)
        mb = self.new_mat()
        self.push(mb, R.PC_NON_BRANCH, 1, lay.pc_out_idx)
        self.push(mb, R.PC_NON_BRANCH, NEG1, lay.pc_in_idx)
        self.push(mb, R.PC_NON_BRANCH, NEG1, lay.instruction_size_idx)
        self.gate([base, base + 1], 1)

    def add_gate(self):
        lay, R = self.lay, self.R
        self._selector_gate(R.ADD, lay.is_add_idx, [
            (1 << 32, lay.has_overflown_idx), (1, lay.val_rd_out_idx),
            (NEG1, lay.val_rs1_idx), (NEG1, lay.val_rs2_idx)])

    def jal_gate(self):
        lay, R = self.lay, self.R
        self._selector_gate(R.JAL, lay.is_jal_idx, [
            (1, lay.val_rd_out_idx), (NEG1, lay.pc_in_idx),
            (NEG1, lay.instruction_size_idx)])

    def jalr_gate(self):
        lay, R = self.lay, self.R
        self._selector_gate(R.JALR, lay.is_jalr_idx, [
            (1, lay.val_rd_out_idx), (NEG1, lay.pc_in_idx),
            (NEG1, lay.instruction_size_idx)])

    def bne_gate(self):
        lay, R = self.lay, self.R
        base = len(self.mats)
        ma = self.new_mat()
        self.push(ma, R.BNE, 1, lay.is_bne_idx)
        mb = self.new_mat()
        self.push(mb, R.BNE, 1, lay.const_1_idx)
        self.push(mb, R.BNE, NEG1, lay.is_branching_idx)
        mc = self.new_mat()
        self.push(mc, R.BNE, 1, lay.val_rs1_idx)
        self.push(mc, R.BNE, NEG1, lay.val_rs2_idx)
        self.gate([base, base + 1, base + 2], 1)

    def auipc_gate(self):
        lay, R = self.lay, self.R
        self._selector_gate(R.AUIPC, lay.is_auipc_idx, [
            (1 << 32, lay.has_overflown_idx), (1, lay.val_rd_out_idx),
            (NEG1, lay.pc_in_idx), (-(1 << 12), lay.imm_idx)])

    def lui_gate(self):
        lay, R = self.lay, self.R
        self._selector_gate(R.LUI, lay.is_lui_idx, [
            (1, lay.val_rd_out_idx), (-(1 << 12), lay.imm_idx)])

    # -- folding-proof linearization gates --------------------------------
    def lin_sumcheck(self):
        lay, R = self.lay, self.R
        p = self.p
        s, LD = p.ccs_s, p.lin_degree
        m_a = self.new_mat()
        self.push(m_a, R.LIN_INITIAL_CLAIM_ZERO, 1, lay.lin_claimed_sums[0])
        for i in range(s):
            row = R.LIN_CLAIMED_SUM_EQUALS[i]
            st = i * LD
            self.push(m_a, row, 1, lay.lin_eval_polynomials_idx[st])
            self.push(m_a, row, 1, lay.lin_eval_polynomials_idx[st + 1])
            self.push(m_a, row, NEG1, lay.lin_claimed_sums[i])
        for i in range(s):
            row = R.LIN_CLAIMED_SUM_SUBTERMS[i]
            self.push(m_a, row, 1, lay.lin_claimed_sums[i + 1])
            for j in range(LD):
                self.push(m_a, row, NEG1,
                          lay.lin_claimed_sums_subterms[i * LD + j])
        self.push(m_a, R.LIN_FINAL_CLAIMED_SUM, 1, lay.lin_expected_eval)
        self.push(m_a, R.LIN_FINAL_CLAIMED_SUM, NEG1, lay.lin_claimed_sums[s])

        m_b = self.new_mat()
        m_c = self.new_mat()
        m_d = self.new_mat()
        m_gated = self.new_mat()
        m_gs1 = self.new_mat()
        m_gsi1 = self.new_mat()
        m_gs2 = self.new_mat()
        m_gsi2 = self.new_mat()
        m_e = self.new_mat()
        m_gs3 = self.new_mat()
        m_gsi3 = self.new_mat()
        m_f = self.new_mat()
        m_g = self.new_mat()

        for i in range(s):
            row = R.LIN_E_XI_YI[i]
            self.push(m_b, row, 1, lay.lin_beta_s_idx[i])
            self.push(m_c, row, 1, lay.lin_eval_point[i])
            self.push(m_d, row, NEG1, lay.lin_e_xi_yi[i])

            row = R.LIN_E_FACTORS[i]
            self.push(m_gated, row, 1, lay.lin_e_factors[i])
            self.push(m_gated, row, -2, lay.lin_e_xi_yi[i])
            self.push(m_gated, row, 1, lay.lin_beta_s_idx[i])
            self.push(m_gated, row, 1, lay.lin_eval_point[i])
            self.push(m_gated, row, NEG1, lay.const_1_idx)
            self.push(m_gs1, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi1, row, 1, lay.ivc_h_i_step_inv_idx)
            self.push(m_gs2, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi2, row, 1, lay.ivc_h_i_step_inv_idx)
            self.push(m_gs3, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi3, row, 1, lay.ivc_h_i_step_inv_idx)

            row = R.LIN_E_SUB_RES[i + 1]
            self.push(m_gs1, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi1, row, 1, lay.ivc_h_i_step_inv_idx)
            self.push(m_gs2, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi2, row, 1, lay.ivc_h_i_step_inv_idx)
            self.push(m_gs3, row, 1, lay.ivc_h_i_step_idx)
            self.push(m_gsi3, row, 1, lay.ivc_h_i_step_inv_idx)
            self.push(m_e, row, 1, lay.lin_e_sub_res[i + 1])
            self.push(m_f, row, 1, lay.lin_e_sub_res[i])
            self.push(m_g, row, 1, lay.lin_e_factors[i])

        row = R.LIN_E_SUB_RES[0]
        self.push(m_gated, row, 1, lay.lin_e_sub_res[0])
        self.push(m_gated, row, NEG1, lay.const_1_idx)
        self.push(m_gs1, row, 1, lay.ivc_h_i_step_idx)
        self.push(m_gsi1, row, 1, lay.ivc_h_i_step_inv_idx)
        self.push(m_gs2, row, 1, lay.ivc_h_i_step_idx)
        self.push(m_gsi2, row, 1, lay.ivc_h_i_step_inv_idx)
        self.push(m_gs3, row, 1, lay.ivc_h_i_step_idx)
        self.push(m_gsi3, row, 1, lay.ivc_h_i_step_inv_idx)

        self.gate([m_a], 1)
        self.gate([m_b, m_c], 1)
        self.gate([m_d], 1)
        self.gate([m_gs1, m_gsi1, m_gated], 1)
        self.gate([m_gs2, m_gsi2, m_e], 1)
        self.gate([m_gs3, m_gsi3, m_f, m_g], NEG1)

    def lin_final_check(self):
        lay, R = self.lay, self.R
        base = len(self.mats)
        m_e = self.new_mat()
        m_inner = self.new_mat()
        m_exp = self.new_mat()
        self.push(m_e, R.LIN_INNER_EVAL, 1, lay.lin_e_sub_res[self.p.ccs_s])
        self.push(m_inner, R.LIN_INNER_EVAL, 1, lay.lin_inner_idx)
        self.push(m_exp, R.LIN_INNER_EVAL, NEG1, lay.lin_expected_eval)
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)

    # -- decomposition recomposition gates -------------------------------
    def decomposition_gate(self):
        lay, R = self.lay, self.R
        p = self.p
        K, KAPPA, TAU = p.K, p.KAPPA, p.TAU
        XW = 4
        b_s = [pow(p.B_SMALL, i, P) for i in range(K)]
        m = self.new_mat()

        def recomp(rows, s_idx, stride, target_idx, count):
            for j in range(count):
                for i in range(K):
                    self.push(m, rows[j], b_s[i], s_idx[i * stride + j])
                self.push(m, rows[j], NEG1, target_idx[j])

        recomp(R.DECOMP_CM, lay.decomp_y_s_idx, KAPPA, lay.decomp_cm_idx,
               KAPPA)
        recomp(R.DECOMP_V, lay.decomp_v_s_idx, TAU, lay.decomp_v_idx, TAU)
        recomp(R.DECOMP_U, lay.decomp_u_s_idx, CCS_NUM_MATRICES,
               lay.decomp_u_idx, CCS_NUM_MATRICES)
        recomp(R.DECOMP_XW, lay.decomp_x_s_idx, XW + 1, lay.decomp_x_w_idx,
               XW)
        for i in range(K):
            self.push(m, R.DECOMP_H, b_s[i],
                      lay.decomp_x_s_idx[i * (XW + 1) + XW])
        self.push(m, R.DECOMP_H, NEG1, lay.decomp_h_idx)

        recomp(R.DECOMP_R_CM, lay.decomp_r_y_s_idx, KAPPA,
               lay.decomp_r_cm_idx, KAPPA)
        recomp(R.DECOMP_R_V, lay.decomp_r_v_s_idx, TAU, lay.decomp_r_v_idx,
               TAU)
        recomp(R.DECOMP_R_U, lay.decomp_r_u_s_idx, CCS_NUM_MATRICES,
               lay.lin_proof_u, CCS_NUM_MATRICES)
        recomp(R.DECOMP_R_XW, lay.decomp_r_x_s_idx, XW + 1,
               lay.decomp_r_x_w_idx, XW)
        for i in range(K):
            self.push(m, R.DECOMP_R_H, b_s[i],
                      lay.decomp_r_x_s_idx[i * (XW + 1) + XW])
        self.push(m, R.DECOMP_R_H, NEG1, lay.decomp_r_h_idx)

        midx = len(self.mats) - 1
        self.gate([midx], 1)

    # -- claim g1 / g3 (preallocated) ------------------------------------
    def preallocate_claim_g1(self):
        base = len(self.mats)
        for _ in range(10):
            self.new_mat()
        idx = {
            "alpha_v2": base, "v2_input": base + 1, "h1_linear": base + 2,
            "alpha_h1": base + 3, "h1_input": base + 4, "h2_linear": base + 5,
            "alpha_h2": base + 6, "h2_input": base + 7,
            "claim_linear": base + 8, "claim_sum": base + 9,
        }
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)
        self.gate([base + 3, base + 4], 1)
        self.gate([base + 5], 1)
        self.gate([base + 6, base + 7], 1)
        self.gate([base + 8], 1)
        self.gate([base + 9], 1)
        return idx

    def fill_claim_g1(self, idx):
        lay, R = self.lay, self.R
        K, TAU = self.p.K, self.p.TAU
        for i in range(2 * K):
            alpha = lay.fp_claim_g1_alpha_idx[i]
            h1 = lay.fp_claim_g1_h1_idx[i]
            h2 = lay.fp_claim_g1_h2_idx[i]
            claim_i = lay.fp_claim_g1_terms_idx[i]
            if i < K:
                v0, v1, v2 = (lay.decomp_v_s_idx[i * TAU],
                              lay.decomp_v_s_idx[i * TAU + 1],
                              lay.decomp_v_s_idx[i * TAU + 2])
            else:
                r = i - K
                v0, v1, v2 = (lay.decomp_r_v_s_idx[r * TAU],
                              lay.decomp_r_v_s_idx[r * TAU + 1],
                              lay.decomp_r_v_s_idx[r * TAU + 2])
            self.push(idx["alpha_v2"], R.G1_H1[i], 1, alpha)
            self.push(idx["v2_input"], R.G1_H1[i], 1, v2)
            self.push(idx["h1_linear"], R.G1_H1[i], NEG1, h1)
            self.push(idx["h1_linear"], R.G1_H1[i], 1, v1)

            self.push(idx["alpha_h1"], R.G1_H2[i], 1, alpha)
            self.push(idx["h1_input"], R.G1_H2[i], 1, h1)
            self.push(idx["h2_linear"], R.G1_H2[i], NEG1, h2)
            self.push(idx["h2_linear"], R.G1_H2[i], 1, v0)

            self.push(idx["alpha_h2"], R.G1_TERM[i], 1, alpha)
            self.push(idx["h2_input"], R.G1_TERM[i], 1, h2)
            self.push(idx["claim_linear"], R.G1_TERM[i], NEG1, claim_i)

            self.push(idx["claim_sum"], R.G1_SUM, 1, claim_i)
        self.push(idx["claim_sum"], R.G1_SUM, NEG1, lay.fp_claim_g1_idx)

    def preallocate_claim_g3(self):
        base = len(self.mats)
        for _ in range(7):
            self.new_mat()
        idx = {
            "zeta_step": base, "step_input": base + 1, "step_linear": base + 2,
            "zeta_term": base + 3, "term_input": base + 4,
            "term_linear": base + 5, "claim_sum": base + 6,
        }
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)
        self.gate([base + 3, base + 4], 1)
        self.gate([base + 5], 1)
        self.gate([base + 6], 1)
        return idx

    def fill_claim_g3(self, idx):
        lay, R = self.lay, self.R
        K = self.p.K
        t = CCS_NUM_MATRICES
        for i in range(2 * K):
            zeta = lay.fp_claim_g3_zeta_idx[i]
            claim_i = lay.fp_claim_g3_terms_idx[i]

            def u_idx(j):
                if i < K:
                    return lay.decomp_u_s_idx[i * t + j]
                return lay.decomp_r_u_s_idx[(i - K) * t + j]

            for sstep in range(t - 1):
                row = R.G3_STEP[i * (t - 1) + sstep]
                h = lay.fp_claim_g3_h_idx[i * (t - 1) + sstep]
                prev = (u_idx(t - 1) if sstep == 0
                        else lay.fp_claim_g3_h_idx[i * (t - 1) + sstep - 1])
                self.push(idx["zeta_step"], row, 1, zeta)
                self.push(idx["step_input"], row, 1, prev)
                self.push(idx["step_linear"], row, NEG1, h)
                self.push(idx["step_linear"], row, 1, u_idx(t - 2 - sstep))

            row = R.G3_TERM[i]
            h_last = lay.fp_claim_g3_h_idx[i * (t - 1) + (t - 2)]
            self.push(idx["zeta_term"], row, 1, zeta)
            self.push(idx["term_input"], row, 1, h_last)
            self.push(idx["term_linear"], row, NEG1, claim_i)
            self.push(idx["claim_sum"], R.G3_SUM, 1, claim_i)
        self.push(idx["claim_sum"], R.G3_SUM, NEG1, lay.fp_claim_g3_idx)

    # -- folding sum-check / final gates ----------------------------------
    def folding_sumcheck(self):
        lay, R = self.lay, self.R
        s = self.p.ccs_s
        ne = self.p.fold_evals
        m = self.new_mat()
        self.push(m, R.FOLD_SC_INITIAL, 1, lay.fp_sumcheck_claimed_sums_idx[0])
        self.push(m, R.FOLD_SC_INITIAL, NEG1, lay.fp_claim_g1_idx)
        self.push(m, R.FOLD_SC_INITIAL, NEG1, lay.fp_claim_g3_idx)
        for i in range(s):
            st = i * ne
            row = R.FOLD_SC_CLAIM_EQ[i]
            self.push(m, row, 1, lay.fp_sumcheck_polynomials_idx[st])
            self.push(m, row, 1, lay.fp_sumcheck_polynomials_idx[st + 1])
            self.push(m, row, NEG1, lay.fp_sumcheck_claimed_sums_idx[i])
            row = R.FOLD_SC_CLAIM_SUB[i]
            self.push(m, row, 1, lay.fp_sumcheck_claimed_sums_idx[i + 1])
            for j in range(ne):
                self.push(m, row, NEG1,
                          lay.fp_sumcheck_claimed_sums_subterms_idx[st + j])
        self.push(m, R.FOLD_SC_FINAL, 1,
                  lay.fp_sumcheck_expected_evaluation_idx)
        self.push(m, R.FOLD_SC_FINAL, NEG1, lay.fp_sumcheck_claimed_sums_idx[s])
        self.gate([len(self.mats) - 1], 1)

    def folding_poc(self):
        lay, R = self.lay, self.R
        m = self.new_mat()
        self.push(m, R.FOLD_EXPECTED, 1, lay.fp_should_equal_s_idx)
        self.push(m, R.FOLD_EXPECTED, NEG1,
                  lay.fp_sumcheck_expected_evaluation_idx)
        self.gate([len(self.mats) - 1], 1)

    def final_cm(self):
        lay, R = self.lay, self.R
        K, KAPPA = self.p.K, self.p.KAPPA
        base = len(self.mats)
        m_child = self.new_mat()
        m_rho = self.new_mat()
        m_prod = self.new_mat()
        m_sum = self.new_mat()
        for j in range(KAPPA):
            for i in range(K):
                row = R.FINAL_CM_PRODUCTS[i * KAPPA + j]
                pidx = lay.fp_final_cm_products_idx[i * KAPPA + j]
                self.push(m_child, row, 1, lay.decomp_y_s_idx[i * KAPPA + j])
                self.push(m_rho, row, 1, lay.fp_rho_s_idx[i])
                self.push(m_prod, row, NEG1, pidx)
                self.push(m_sum, R.FINAL_CM_EQ[j], 1, pidx)
            off = K * KAPPA
            for i in range(K):
                row = R.FINAL_CM_PRODUCTS[off + i * KAPPA + j]
                pidx = lay.fp_final_cm_products_idx[off + i * KAPPA + j]
                self.push(m_child, row, 1, lay.decomp_r_y_s_idx[i * KAPPA + j])
                self.push(m_rho, row, 1, lay.fp_rho_s_idx[K + i])
                self.push(m_prod, row, NEG1, pidx)
                self.push(m_sum, R.FINAL_CM_EQ[j], 1, pidx)
            self.push(m_sum, R.FINAL_CM_EQ[j], NEG1, lay.acc_out_cm_idx[j])
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)
        self.gate([base + 3], 1)

    def final_u(self):
        lay, R = self.lay, self.R
        K = self.p.K
        t = CCS_NUM_MATRICES
        base = len(self.mats)
        m_eta = self.new_mat()
        m_rho = self.new_mat()
        m_prod = self.new_mat()
        m_step = self.new_mat()
        m_step_inv = self.new_mat()
        m_sum = self.new_mat()
        for j in range(t):
            self.push(m_step, R.FINAL_U_EQ[j], 1, lay.ivc_h_i_step_idx)
            self.push(m_step_inv, R.FINAL_U_EQ[j], 1, lay.ivc_h_i_step_inv_idx)
            for i in range(2 * K):
                row = R.FINAL_U_PRODUCTS[i * t + j]
                pidx = lay.fp_final_u_products_idx[i * t + j]
                self.push(m_eta, row, 1, lay.fp_eta_s_idx[i * t + j])
                self.push(m_rho, row, 1, lay.fp_rho_s_idx[i])
                self.push(m_prod, row, NEG1, pidx)
                self.push(m_sum, R.FINAL_U_EQ[j], 1, pidx)
            self.push(m_sum, R.FINAL_U_EQ[j], NEG1, lay.acc_out_u_idx[j])
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)
        self.gate([base + 3, base + 4, base + 5], 1)

    def final_x(self):
        lay, R = self.lay, self.R
        K = self.p.K
        XW = 4
        base = len(self.mats)
        m_x = self.new_mat()
        m_rho = self.new_mat()
        m_prod = self.new_mat()
        m_step = self.new_mat()
        m_step_inv = self.new_mat()
        m_sum = self.new_mat()
        for j in range(XW + 1):
            sum_row = R.FINAL_XW_EQ[j] if j < XW else R.FINAL_H_EQ
            self.push(m_step, sum_row, 1, lay.ivc_h_i_step_idx)
            self.push(m_step_inv, sum_row, 1, lay.ivc_h_i_step_inv_idx)
            for i in range(2 * K):
                row = R.FINAL_X_PRODUCTS[i * (XW + 1) + j]
                pidx = lay.fp_final_x_products_idx[i * (XW + 1) + j]
                if i < K:
                    x_idx = lay.decomp_x_s_idx[i * (XW + 1) + j]
                else:
                    x_idx = lay.decomp_r_x_s_idx[(i - K) * (XW + 1) + j]
                self.push(m_x, row, 1, x_idx)
                self.push(m_rho, row, 1, lay.fp_rho_s_idx[i])
                self.push(m_prod, row, NEG1, pidx)
                self.push(m_sum, sum_row, 1, pidx)
            if j < XW:
                self.push(m_sum, R.FINAL_XW_EQ[j], NEG1,
                          lay.acc_out_x_w_idx[j])
            else:
                self.push(m_sum, R.FINAL_H_EQ, NEG1, lay.acc_out_h_idx)
        self.gate([base, base + 1], 1)
        self.gate([base + 2], 1)
        self.gate([base + 3, base + 4, base + 5], 1)

    # -- linearization inner (preallocated, filled LAST) ------------------
    def preallocate_lin_inner(self):
        base = len(self.mats)
        for _ in range(SBOX_DEGREE + 2):
            self.new_mat()
        self.gate([base + i for i in range(SBOX_DEGREE)], 1)
        self.gate([base + SBOX_DEGREE], NEG1)
        self.gate([base + SBOX_DEGREE + 1], 1)
        assert len(self.multisets) == CCS_C, len(self.multisets)
        return base

    def fill_lin_inner(self, base):
        lay, R = self.lay, self.R
        matrix_multiset = self.multisets[-3]
        for i, s in enumerate(self.multisets):
            assert len(s) <= SBOX_DEGREE
            row = R.LIN_INNER_PRODS_PER_MULTISET[i]
            for j, u_j in enumerate(s):
                self.mats[matrix_multiset[j]].append(
                    (row, lay.lin_proof_u[u_j], 1))
            for j in range(len(s), SBOX_DEGREE):
                self.mats[matrix_multiset[j]].append(
                    (row, lay.const_1_idx, 1))
            self.mats[len(self.mats) - 2].append(
                (row, lay.lin_inner_products_per_multiset[i], 1))
        m_inner = self.mats[len(self.mats) - 1]
        m_inner.append((R.LIN_INNER_DECOMP, lay.lin_inner_idx, 1))
        for i, cc in enumerate(self.coeffs):
            m_inner.append((R.LIN_INNER_DECOMP,
                            lay.lin_inner_products_per_multiset[i],
                            (-cc) % P))

    # -- build ------------------------------------------------------------
    def build(self) -> CCS:
        lay = self.lay
        n = lay.z_size
        m_padded = max((n - lay.X_ELEMS_SIZE - 1) * self.p.L, self.m)
        m_padded = 1 << (m_padded - 1).bit_length()
        assert self.R.total_rows <= m_padded, \
            (self.R.total_rows, m_padded)
        mats = [SparseScalarMatrix.from_entries(m_padded, n, entries)
                for entries in self.mats]
        d = max(len(s) for s in self.multisets)
        return CCS(m=m_padded, n=n, l=lay.X_ELEMS_SIZE,
                   t=len(self.mats), q=len(self.multisets), d=d,
                   M=mats, S=[list(s) for s in self.multisets],
                   c=[H.ntt_from_u64(cc) for cc in self.coeffs])


def create_riscv_ccs(layout) -> CCS:
    """(constraints.rs:73-118) — gate families in exact reference order."""
    W = layout.w_size * layout.params.L
    b = CCSBuilder(layout, W)
    b.ivc_step_inv()
    b.ivc_after_initial_mds()
    b.ivc_external_initial()
    b.ivc_internal_rounds()
    b.ivc_external_terminal()
    b.ivc_result_hash()
    b.pc_non_branching()
    b.add_gate()
    b.jal_gate()
    b.jalr_gate()
    b.bne_gate()
    b.auipc_gate()
    b.lui_gate()
    b.lin_sumcheck()
    b.lin_final_check()
    b.decomposition_gate()
    g1 = b.preallocate_claim_g1()
    g3 = b.preallocate_claim_g3()
    b.folding_sumcheck()
    b.folding_poc()
    b.final_cm()
    b.final_u()
    b.final_x()
    lin_inner_base = b.preallocate_lin_inner()
    assert len(b.mats) == CCS_NUM_MATRICES, len(b.mats)
    b.fill_claim_g1(g1)
    b.fill_claim_g3(g3)
    b.fill_lin_inner(lin_inner_base)
    return b.build()
