"""ckpt_s: seconds a step in writing checkpoints, the span around
`TorchZkVmProver.save_checkpoint` (every tenth fold), averaged over all
the window's steps."""

TARGETS = {"ckpt_s": [("latticeum_tpu_torch.zkvm.prover",
                       "TorchZkVmProver.save_checkpoint")]}


def read(w):
    return w.span_per_step("ckpt_s")
