"""The numpy host protocol the port runs around its torch fold step.

Copies of the jax-free host modules of ``latticeum_tpu`` (field limb
arithmetic, ring reference, MLEs and sum-check, the NIFS host prover and
verifier, Poseidon2 and the transcript, the Ajtai scheme, the RISC-V VM,
and the zkVM CCS builder, witness, collector, commitments and checkpoints),
in the same relative layout: ``host/X/y.py`` is the copy of
``latticeum_tpu/X/y.py``.  The port imports nothing of ``latticeum_tpu``;
``tests/test_torch_host_copy.py`` holds these copies against it.
"""
