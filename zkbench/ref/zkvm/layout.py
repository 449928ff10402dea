"""CCS z-vector layout: absolute index map for every witness region.

Python mirror of the reference's const-eval CCSLayout
(latticeum/crates/zkvm/src/ccs.rs:76-498).  z = [x_ccs(4) || 1 || w_ccs].
"""

from __future__ import annotations

from .params import (CCS_C, CCS_NUM_MATRICES, FULL_ROUNDS, N_REGS,
                     PARTIAL_ROUNDS, P2_OUT, P2_WIDTH, SPONGE_PASSES,
                     ZkVmParams)


class _Cursor:
    def __init__(self):
        self.pos = 0

    def take(self, n):
        r = list(range(self.pos, self.pos + n))
        self.pos += n
        return r

    def one(self):
        r = self.pos
        self.pos += 1
        return r


class CCSLayout:
    X_ELEMS_SIZE = 4
    CONST_ELEMS_SIZE = 1
    W_IDX_DELTA = X_ELEMS_SIZE + CONST_ELEMS_SIZE

    def __init__(self, p: ZkVmParams):
        self.params = p
        CCS_S = p.ccs_s
        LIN_DEG = p.lin_degree
        K, KAPPA, TAU = p.K, p.KAPPA, p.TAU
        XW = self.X_ELEMS_SIZE  # DECOMP_X_W_LEN

        c = _Cursor()
        self.ivc_h_i_idx = c.take(P2_OUT)
        self.const_1_idx = c.one()
        self.ivc_h_i_step_idx = c.one()
        self.ivc_h_i_step_inv_idx = c.one()
        self.ivc_h_i_state_0_comm_idx = c.take(P2_OUT)
        self.ivc_h_i_state_i_comm_idx = c.take(P2_OUT)
        self.ivc_h_i_acc_i_comm_idx = c.take(P2_OUT)
        self.ivc_h_i_after_mds_idx = c.take(SPONGE_PASSES * P2_WIDTH)
        self.ivc_h_i_external_initial = c.take(FULL_ROUNDS * P2_WIDTH)
        self.ivc_h_i_after_internal_idx = c.take(
            SPONGE_PASSES * PARTIAL_ROUNDS * P2_WIDTH)
        self.ivc_h_i_external_terminal = c.take(FULL_ROUNDS * P2_WIDTH)

        self.lin_beta_s_idx = c.take(CCS_S)
        self.lin_eval_polynomials_idx = c.take(CCS_S * LIN_DEG)
        self.lin_claimed_sums = c.take(CCS_S + 1)
        self.lin_claimed_sums_subterms = c.take(CCS_S * LIN_DEG)
        self.lin_expected_eval = c.one()
        self.lin_eval_point = c.take(CCS_S)
        self.lin_e_xi_yi = c.take(CCS_S)
        self.lin_e_factors = c.take(CCS_S)
        self.lin_e_sub_res = c.take(CCS_S + 1)
        self.lin_proof_u = c.take(CCS_NUM_MATRICES)
        self.lin_inner_idx = c.one()
        self.lin_inner_products_per_multiset = c.take(CCS_C)

        self.decomp_cm_idx = c.take(KAPPA)
        self.decomp_y_s_idx = c.take(K * KAPPA)
        self.decomp_v_idx = c.take(TAU)
        self.decomp_v_s_idx = c.take(K * TAU)
        self.decomp_u_idx = c.take(CCS_NUM_MATRICES)
        self.decomp_u_s_idx = c.take(K * CCS_NUM_MATRICES)
        self.decomp_x_w_idx = c.take(XW)
        self.decomp_h_idx = c.one()
        self.decomp_x_s_idx = c.take(K * (XW + 1))

        self.decomp_r_cm_idx = c.take(KAPPA)
        self.decomp_r_y_s_idx = c.take(K * KAPPA)
        self.decomp_r_v_idx = c.take(TAU)
        self.decomp_r_v_s_idx = c.take(K * TAU)
        self.decomp_r_u_s_idx = c.take(K * CCS_NUM_MATRICES)
        self.decomp_r_x_w_idx = c.take(XW)
        self.decomp_r_h_idx = c.one()
        self.decomp_r_x_s_idx = c.take(K * (XW + 1))

        self.fp_claim_g1_alpha_idx = c.take(2 * K)
        self.fp_claim_g1_h1_idx = c.take(2 * K)
        self.fp_claim_g1_h2_idx = c.take(2 * K)
        self.fp_claim_g1_terms_idx = c.take(2 * K)
        self.fp_claim_g1_idx = c.one()

        self.fp_claim_g3_zeta_idx = c.take(2 * K)
        self.fp_claim_g3_h_idx = c.take(2 * K * (CCS_NUM_MATRICES - 1))
        self.fp_claim_g3_terms_idx = c.take(2 * K)
        self.fp_claim_g3_idx = c.one()

        self.fp_sumcheck_polynomials_idx = c.take(CCS_S * p.fold_evals)
        self.fp_sumcheck_claimed_sums_idx = c.take(CCS_S + 1)
        self.fp_sumcheck_claimed_sums_subterms_idx = c.take(
            CCS_S * p.fold_evals)
        self.fp_sumcheck_evaluation_point_idx = c.take(CCS_S)
        self.fp_sumcheck_expected_evaluation_idx = c.one()
        self.fp_should_equal_s_idx = c.one()
        self.fp_rho_s_idx = c.take(2 * K)
        self.fp_eta_s_idx = c.take(2 * K * CCS_NUM_MATRICES)
        self.fp_final_cm_products_idx = c.take(2 * K * KAPPA)
        self.fp_final_u_products_idx = c.take(2 * K * CCS_NUM_MATRICES)
        self.fp_final_x_products_idx = c.take(2 * K * (XW + 1))

        self.acc_out_r_idx = c.take(CCS_S)
        self.acc_out_v_idx = c.take(TAU)
        self.acc_out_cm_idx = c.take(KAPPA)
        self.acc_out_u_idx = c.take(CCS_NUM_MATRICES)
        self.acc_out_x_w_idx = c.take(XW)
        self.acc_out_h_idx = c.one()

        self.pc_in_idx = c.one()
        self.regs_in_idx = c.take(N_REGS)
        self.instruction_size_idx = c.one()
        self.is_branching_idx = c.one()
        self.branched_to_idx = c.one()
        self.imm_idx = c.one()
        self.is_add_idx = c.one()
        self.is_addi_idx = c.one()
        self.is_bne_idx = c.one()
        self.is_lui_idx = c.one()
        self.is_auipc_idx = c.one()
        self.is_jal_idx = c.one()
        self.is_jalr_idx = c.one()
        self.is_sw_idx = c.one()
        self.val_rs1_idx = c.one()
        self.val_rs2_idx = c.one()
        self.has_overflown_idx = c.one()
        self.pc_out_idx = c.one()
        self.regs_out_idx = c.take(N_REGS)
        self.val_rd_out_idx = c.one()

        self.w_size = c.pos - self.W_IDX_DELTA

    @property
    def z_size(self) -> int:
        return self.X_ELEMS_SIZE + self.CONST_ELEMS_SIZE + self.w_size
