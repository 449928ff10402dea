"""NIFS composition (latticefold/src/nifs.rs:29-173):
prove = absorb(acc, cm_i) ∥ Πlin(cm_i) ∥ Πdecomp(acc) ∥ Πdecomp(lin cm_i)
        ∥ Πfold(2K instances).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import host as H
from . import decomposition as dec, folding as fold, linearization as lin
from .structs import CCCS, LCCCS

ACC_DS = int.from_bytes(b"acc", "big")
CMI_DS = int.from_bytes(b"cm_i", "big")


@dataclass
class DecompositionParams:
    B: int
    L: int
    B_SMALL: int
    K: int


def sanity_check(ccs, params):
    expect = max((ccs.n - ccs.l - 1) * params.L, ccs.m)
    expect = 1 << (expect - 1).bit_length()
    if ccs.m != expect:
        raise ValueError(f"CCS m={ccs.m} not padded to {expect}")


def absorb_public_input(acc: LCCCS, cm_i: CCCS, transcript):
    """(nifs.rs:179-197)"""
    transcript.absorb_fq3(H.fq3_scalar(ACC_DS))
    transcript.absorb_slice(acc.r)
    transcript.absorb_slice(acc.v)
    transcript.absorb_slice(acc.cm)
    transcript.absorb_slice(acc.u)
    transcript.absorb_slice(acc.x_w)
    transcript.absorb_ring(acc.h)
    transcript.absorb_fq3(H.fq3_scalar(CMI_DS))
    transcript.absorb_slice(cm_i.cm)
    transcript.absorb_slice(cm_i.x_ccs)


def prove(acc, w_acc, cm_i, w_i, transcript, ccs, scheme, params):
    """Returns (folded_lcccs, folded_witness, proof dict)."""
    sanity_check(ccs, params)
    absorb_public_input(acc, cm_i, transcript)
    linearized_cm_i, lin_proof, _ = lin.prove(cm_i, w_i, transcript, ccs)
    z_l, lcccs_l, wit_l, dec_proof_l = dec.prove(
        acc, w_acc, transcript, ccs, scheme, params)
    z_r, lcccs_r, wit_r, dec_proof_r = dec.prove(
        linearized_cm_i, w_i, transcript, ccs, scheme, params)
    lcccs_s = lcccs_l + lcccs_r
    wit_s = wit_l + wit_r
    z_s = z_l + z_r
    folded, w0, fold_proof = fold.prove(
        lcccs_s, wit_s, transcript, ccs, z_s, params)
    proof = {"linearization": lin_proof, "decomposition_l": dec_proof_l,
             "decomposition_r": dec_proof_r, "folding": fold_proof}
    return folded, w0, proof


def verify(acc, cm_i, proof, transcript, ccs, params):
    sanity_check(ccs, params)
    absorb_public_input(acc, cm_i, transcript)
    linearized_cm_i = lin.verify(cm_i, proof["linearization"], transcript, ccs)
    dec_l = dec.verify(acc, proof["decomposition_l"], transcript, ccs, params)
    dec_r = dec.verify(linearized_cm_i, proof["decomposition_r"], transcript,
                       ccs, params)
    return fold.verify(dec_l + dec_r, proof["folding"], transcript, ccs,
                       params)


def proof_size_elements(proof) -> int:
    """Rough LFProof size: number of ring elements in the proof."""
    def count(x):
        if isinstance(x, dict):
            return sum(count(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            if x and isinstance(x[0], int):
                return 1
            return sum(count(v) for v in x)
        return 0
    return count(proof)
