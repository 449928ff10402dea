"""The sharded sum-checks over ``torch.distributed`` (counterpart of
``latticeum_tpu/parallel/``): the process mesh and its communicator, the
plain-torch cores, the rows-sharded fold and lin sum-checks, the slots
CRT exchange and multi-process initialization."""
