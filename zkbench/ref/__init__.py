"""The benchmark's plain reference: a frozen copy of the numpy host
protocol of ``latticeum_tpu_torch/host/`` at commit 2adeb7e (field limb
arithmetic, ring reference, MLEs and sum-check, the NIFS verifier,
Poseidon2 and the transcript, the row-constant Ajtai scheme, the RISC-V
VM and assembler, and the zkVM CCS builder, witness, collector and
commitments), in the same relative layout, with the native Poseidon2 core
left out: its Poseidon2 is pure Python.  It imports nothing of the
program, nor torch, nor jax; a later change to the program does not move
it.
"""
