"""Witness generation: fill the CCS z-vector for one IVC step.

Mirrors latticeum/crates/zkvm/src/ccs.rs:500-963 (set_ivc_h_witness,
set_trace_witness, set_acc_out_witness, set_folding_proof_witness) and
ivc.rs:104-124 (arithmetize).

The scalar region is built as ints (Rust builds a Vec<usize> then maps via
R::from(u64), so negative i32 immediates become (2^64 + imm) mod p — the
same conversion is applied here).  The folding-proof/acc regions hold full
ring elements.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import host as H
from .params import (CCS_NUM_MATRICES, FULL_ROUNDS, PARTIAL_ROUNDS, P2_OUT,
                     P2_WIDTH, SPONGE_PASSES)

P = H.P
M64 = (1 << 64)


def _imm_to_field(imm: int) -> int:
    """i32 -> usize -> u64 -> Fq (ccs.rs `imm as usize` + to_F_vec)."""
    return (imm % M64) % P if imm >= 0 else ((imm + M64) % M64) % P


@dataclass
class IVCStepInput:
    ivc_step_comm: tuple          # (digest[4], perm_states list)
    ivc_step: int                 # i - 1
    state_0_comm: list
    state_comm: list
    acc_comm: list
    acc: object                   # LCCCS (host rings)
    folding_proof_vars: object    # dict or None
    w_acc: object                 # Witness
    trace: object                 # ExecutionTrace


def set_ivc_h_witness(z: list, inp: IVCStepInput, lay):
    step = inp.ivc_step % P
    z[lay.ivc_h_i_step_idx] = step
    z[lay.ivc_h_i_step_inv_idx] = pow(step, P - 2, P) if step else 0
    for i, zi in enumerate(lay.ivc_h_i_state_0_comm_idx):
        z[zi] = inp.state_0_comm[i]
    for i, zi in enumerate(lay.ivc_h_i_state_i_comm_idx):
        z[zi] = inp.state_comm[i]
    for i, zi in enumerate(lay.ivc_h_i_acc_i_comm_idx):
        z[zi] = inp.acc_comm[i]

    states = inp.ivc_step_comm[1]
    assert len(states) == SPONGE_PASSES
    flat_mds = [v for st in states for v in st["after_initial_mds"]]
    for i, zi in enumerate(lay.ivc_h_i_after_mds_idx):
        z[zi] = flat_mds[i]
    flat_ext_init = [v for st in states
                     for rnd in st["after_ext_init"] for v in rnd]
    for i, zi in enumerate(lay.ivc_h_i_external_initial):
        z[zi] = flat_ext_init[i]
    flat_internal = [v for st in states
                     for rnd in st["after_internal"] for v in rnd]
    for i, zi in enumerate(lay.ivc_h_i_after_internal_idx):
        z[zi] = flat_internal[i]
    flat_ext_term = [v for st in states
                     for rnd in st["after_ext_term"] for v in rnd]
    for i, zi in enumerate(lay.ivc_h_i_external_terminal):
        z[zi] = flat_ext_term[i]


def set_trace_witness(z: list, trace, lay):
    z[lay.pc_in_idx] = trace.input.pc
    for i, zi in enumerate(lay.regs_in_idx):
        z[zi] = trace.input.regs[i]
    z[lay.instruction_size_idx] = trace.instruction.size

    n = trace.instruction.name
    a = trace.instruction.args
    se = trace.side_effects
    if n == "LUI":
        z[lay.is_lui_idx] = 1
        z[lay.imm_idx] = a["imm"]
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
    elif n == "AUIPC":
        z[lay.is_auipc_idx] = 1
        z[lay.imm_idx] = a["imm"]
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
        z[lay.has_overflown_idx] = int(se.has_overflown)
    elif n == "JAL":
        z[lay.is_jal_idx] = 1
        z[lay.imm_idx] = _imm_to_field(a["offset"])
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
        z[lay.is_branching_idx] = 1
        z[lay.branched_to_idx] = se.branched_to
    elif n == "JALR":
        z[lay.is_jalr_idx] = 1
        z[lay.val_rs1_idx] = trace.input.regs[a["rs1"]]
        z[lay.imm_idx] = _imm_to_field(a["offset"])
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
        z[lay.is_branching_idx] = 1
        z[lay.branched_to_idx] = se.branched_to
    elif n == "BNE":
        z[lay.is_bne_idx] = 1
        z[lay.val_rs1_idx] = trace.input.regs[a["rs1"]]
        z[lay.val_rs2_idx] = trace.input.regs[a["rs2"]]
        z[lay.imm_idx] = _imm_to_field(a["offset"])
        z[lay.is_branching_idx] = int(se.branched_to is not None)
        z[lay.branched_to_idx] = se.branched_to or 0
    elif n == "SW":
        z[lay.is_sw_idx] = 1
        z[lay.val_rs1_idx] = trace.input.regs[a["rs1"]]
        z[lay.val_rs2_idx] = trace.input.regs[a["rs2"]]
        z[lay.imm_idx] = _imm_to_field(a["offset"])
    elif n == "ADDI":
        z[lay.is_addi_idx] = 1
        z[lay.val_rs1_idx] = trace.input.regs[a["rs1"]]
        z[lay.imm_idx] = _imm_to_field(a["imm"])
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
        z[lay.has_overflown_idx] = int(se.has_overflown)
    elif n == "ADD":
        z[lay.is_add_idx] = 1
        z[lay.val_rs1_idx] = trace.input.regs[a["rs1"]]
        z[lay.val_rs2_idx] = trace.input.regs[a["rs2"]]
        z[lay.val_rd_out_idx] = trace.output.regs[a["rd"]]
        z[lay.has_overflown_idx] = int(se.has_overflown)
    elif se.branched_to is not None:
        # opcodes without dedicated gates (warn-only in the reference,
        # ccs.rs:958): a taken branch must still satisfy the universal
        # pc_non_branching gate (1-is_br)(pc_out-pc_in-size), so record the
        # branch.  Value semantics of such opcodes stay unconstrained,
        # exactly like the reference's gateless handling.
        z[lay.is_branching_idx] = 1
        z[lay.branched_to_idx] = se.branched_to
    # other instructions: warn-only in the reference (ccs.rs:958)

    z[lay.pc_out_idx] = trace.output.pc
    for i, zi in enumerate(lay.regs_out_idx):
        z[zi] = trace.output.regs[i]


def set_acc_out_witness(z_rings: list, acc, lay):
    for i, zi in enumerate(lay.acc_out_r_idx):
        z_rings[zi] = list(acc.r[i])
    for i, zi in enumerate(lay.acc_out_v_idx):
        z_rings[zi] = list(acc.v[i])
    for i, zi in enumerate(lay.acc_out_cm_idx):
        z_rings[zi] = list(acc.cm[i])
    for i, zi in enumerate(lay.acc_out_u_idx):
        z_rings[zi] = list(acc.u[i])
    for i, zi in enumerate(lay.acc_out_x_w_idx):
        z_rings[zi] = list(acc.x_w[i])
    z_rings[lay.acc_out_h_idx] = list(acc.h)


def set_folding_proof_witness(z_rings: list, vars: dict, lay):
    p = lay.params
    LIN_DEG = p.lin_degree
    K, KAPPA, TAU = p.K, p.KAPPA, p.TAU
    XW = 4
    t = CCS_NUM_MATRICES
    lv = vars["linearization"]

    def fill(indices, values):
        assert len(indices) == len(values), (len(indices), len(values))
        for zi, v in zip(indices, values):
            z_rings[zi] = list(v)

    fill(lay.lin_beta_s_idx, lv["beta_s"])
    fill(lay.lin_eval_polynomials_idx,
         [e for poly in lv["evaluation_polynomials"] for e in poly])
    z_rings[lay.lin_expected_eval] = list(lv["expected_evaluation"])
    fill(lay.lin_claimed_sums, lv["claimed_sums"])
    fill(lay.lin_claimed_sums_subterms, lv["claimed_sums_subterms"])
    fill(lay.lin_eval_point, lv["evaluation_point"])
    fill(lay.lin_e_xi_yi, lv["e_xi_yis"])
    fill(lay.lin_e_factors, lv["e_factors"])
    fill(lay.lin_e_sub_res, lv["e_sub_res"])
    fill(lay.lin_proof_u, lv["u"])
    z_rings[lay.lin_inner_idx] = list(lv["inner"])
    fill(lay.lin_inner_products_per_multiset, lv["inner_per_multiset"])

    for side, pref in (("decomp_l", ""), ("decomp_r", "r_")):
        dv = vars[side]
        fill(getattr(lay, f"decomp_{pref}cm_idx"), dv["cm"])
        fill(getattr(lay, f"decomp_{pref}y_s_idx"),
             [y for ys in dv["y_s"] for y in ys])
        fill(getattr(lay, f"decomp_{pref}v_idx"), dv["v"])
        fill(getattr(lay, f"decomp_{pref}v_s_idx"),
             [v for vs in dv["v_s"] for v in vs])
        if pref == "":
            fill(lay.decomp_u_idx, dv["u"])
            fill(lay.decomp_u_s_idx, [u for us in dv["u_s"] for u in us])
            fill(lay.decomp_x_w_idx, dv["x_w"])
            z_rings[lay.decomp_h_idx] = list(dv["h"])
            fill(lay.decomp_x_s_idx, [x for xs in dv["x_s"] for x in xs])
        else:
            fill(lay.decomp_r_u_s_idx, [u for us in dv["u_s"] for u in us])
            fill(lay.decomp_r_x_w_idx, dv["x_w"])
            z_rings[lay.decomp_r_h_idx] = list(dv["h"])
            fill(lay.decomp_r_x_s_idx, [x for xs in dv["x_s"] for x in xs])

    fv = vars["folding"]
    fill(lay.fp_claim_g1_alpha_idx, fv["alpha_s"])
    fill(lay.fp_claim_g1_h1_idx, fv["claim_g1_h1"])
    fill(lay.fp_claim_g1_h2_idx, fv["claim_g1_h2"])
    fill(lay.fp_claim_g1_terms_idx, fv["claim_g1_terms"])
    z_rings[lay.fp_claim_g1_idx] = list(fv["claim_g1"])
    fill(lay.fp_claim_g3_zeta_idx, fv["zeta_s"])
    fill(lay.fp_claim_g3_h_idx, fv["claim_g3_h"])
    fill(lay.fp_claim_g3_terms_idx, fv["claim_g3_terms"])
    z_rings[lay.fp_claim_g3_idx] = list(fv["claim_g3"])
    fill(lay.fp_sumcheck_polynomials_idx,
         [e for poly in fv["sumcheck_polynomials"] for e in poly])
    fill(lay.fp_sumcheck_claimed_sums_idx, fv["sumcheck_claimed_sums"])
    fill(lay.fp_sumcheck_claimed_sums_subterms_idx,
         fv["sumcheck_claimed_sums_subterms"])
    fill(lay.fp_sumcheck_evaluation_point_idx, fv["sumcheck_evaluation_point"])
    z_rings[lay.fp_sumcheck_expected_evaluation_idx] = \
        list(fv["sumcheck_expected_evaluation"])
    z_rings[lay.fp_should_equal_s_idx] = list(fv["should_equal_s"])
    fill(lay.fp_rho_s_idx, fv["rho_s"])
    fill(lay.fp_eta_s_idx, fv["eta_s"])
    fill(lay.fp_final_cm_products_idx, fv["final_cm_products"])
    fill(lay.fp_final_u_products_idx, fv["final_u_products"])
    fill(lay.fp_final_x_products_idx, fv["final_x_products"])


def arithmetize(inp: IVCStepInput, lay) -> list:
    """-> z as a list of host rings (24-int lists), length lay.z_size."""
    z_scalars = [0] * lay.z_size
    for i, zi in enumerate(lay.ivc_h_i_idx):
        z_scalars[zi] = inp.ivc_step_comm[0][i]
    z_scalars[lay.const_1_idx] = 1
    set_ivc_h_witness(z_scalars, inp, lay)
    set_trace_witness(z_scalars, inp.trace, lay)

    z_rings = [H.ntt_from_u64(v) for v in z_scalars]
    set_acc_out_witness(z_rings, inp.acc, lay)
    if inp.folding_proof_vars is not None:
        set_folding_proof_witness(z_rings, inp.folding_proof_vars, lay)
    return z_rings
