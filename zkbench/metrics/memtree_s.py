"""memtree_s: seconds a step in the memory tree's page updates and the
memory-op chain (spans around `IncrementalMemTree.update_page` and
`ZkVmCommitter.vm_mem_ops_vec_comm` as the prover module sees them)."""

TARGETS = {"memtree_s": [
    ("latticeum_tpu_torch.zkvm.prover", "IncrementalMemTree.update_page"),
    ("latticeum_tpu_torch.zkvm.prover",
     "ZkVmCommitter.vm_mem_ops_vec_comm")]}


def read(w):
    return w.span_per_step("memtree_s")
