"""The port's Poseidon2 width-8 (crypto/poseidon2.py) and the trees built on
it (zkvm/commitments.py) against the JAX package.

perm8's plain-torch twin is held against the JAX package's batched
``crypto/poseidon2.perm8`` on the numpy backend (the plain reference the
Pallas kernel ``parallel/pallas_kernels.py:109`` was checked against on the
TPU) and against the scalar oracle ``poseidon2_ref.perm8``; the Merkle
levels, the memory and code roots and IncrementalMemTree against the JAX
package's host trees.  Tolerance: none (exact integers).  The CUDA kernel is
checked against the twin on the card (``cuda`` marker)."""

import numpy as np
import pytest
import torch

from latticeum_tpu import backend as B
from latticeum_tpu.crypto import poseidon2 as p2_jax, poseidon2_ref as p2_ref
from latticeum_tpu.field import goldilocks as gl_ref
from latticeum_tpu.vm.assembler import fib_const_guest
from latticeum_tpu.vm.vm import VM
from latticeum_tpu.zkvm import commitments as jax_comm
from latticeum_tpu.zkvm.prover import IncrementalMemTree as JaxMemTree
from latticeum_tpu_torch.crypto import poseidon2
from latticeum_tpu_torch.field import goldilocks as gl
from latticeum_tpu_torch.zkvm import commitments

EDGES = [0, 1, 2, 0xFFFFFFFF, 1 << 32, gl.P - 1]


def states(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, gl.P, (n, 8), dtype=np.uint64)
    u.reshape(-1)[:len(EDGES)] = EDGES
    return u


def limbs(u):
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def port(u):
    return torch.from_numpy(gl.to_i64_bits(u))


@pytest.fixture(scope="module")
def perm_case():
    u = states(64, 0)
    return u, gl.to_int_lists(poseidon2.perm8_twin(port(u)))


@pytest.mark.parametrize("reference", ["jax_batched", "scalar_oracle"])
def test_perm8_twin_matches_reference(perm_case, reference):
    u, got = perm_case
    if reference == "jax_batched":
        with B.numpy_mode():
            out = p2_jax.perm8(limbs(u))
        want = gl_ref.to_int((np.asarray(out[0]), np.asarray(out[1])))
        want = [[int(v) for v in row] for row in want]
    else:
        want = [p2_ref.perm8([int(v) for v in row]) for row in u]
    assert got == want


def test_perm8_edge_values_each_position():
    """Every edge value in every lane, the rest zero."""
    u = np.zeros((8 * len(EDGES), 8), np.uint64)
    for i, v in enumerate(EDGES):
        for lane in range(8):
            u[8 * i + lane, lane] = v
    got = gl.to_int_lists(poseidon2.perm8(port(u)))
    assert got == [p2_ref.perm8([int(v) for v in row]) for row in u]


def test_perm8_wrapper_checks_its_input():
    with pytest.raises(TypeError):
        poseidon2.perm8(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        poseidon2.perm8(torch.zeros((4, 7), dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon2.perm8(torch.zeros((8, 4), dtype=torch.int64).T)
    assert poseidon2.perm8(torch.zeros((0, 8), dtype=torch.int64)).shape == (0, 8)


@pytest.mark.parametrize("shape", [(5, 7), (16, 256), (300, 1)])
def test_merkle_levels_rows_match_host_tree(shape):
    rng = np.random.default_rng(shape[0])
    rows = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
    got = [gl.to_int_lists(lv) for lv in poseidon2.merkle_levels_rows(
        torch.from_numpy(rows.astype(np.int64)))]
    leaves = [jax_comm._leaf_digest([int(v) for v in r]) for r in rows]
    assert got == jax_comm.merkle_levels(leaves)
    assert got[-1][0] == jax_comm.merkle_root_of_rows(
        [[int(v) for v in r] for r in rows])


def test_hash_rows_and_compress_match_jax_batched():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 32, (6, 9), dtype=np.uint64)
    with B.numpy_mode():
        dig = p2_jax.hash_rows_narrow(rows)
        comp = p2_jax.compress_level(dig)
    want = gl_ref.to_int((np.asarray(dig[0]), np.asarray(dig[1])))
    got = poseidon2.hash_rows_narrow(torch.from_numpy(rows.astype(np.int64)))
    assert np.array_equal(gl.to_u64(got), want.astype(np.uint64))
    want_c = gl_ref.to_int((np.asarray(comp[0]), np.asarray(comp[1])))
    assert np.array_equal(gl.to_u64(poseidon2.compress_level(got)),
                          want_c.astype(np.uint64))


@pytest.fixture(scope="module")
def fib_vm():
    # 128 pages: the guests touch address 0x11000
    return VM(256, 128).load_elf_data(fib_const_guest(0xC594BFC3))


def test_vm_mem_comm_matches_jax(fib_vm):
    assert (commitments.ZkVmCommitter("cpu").vm_mem_comm(fib_vm)
            == jax_comm.ZkVmCommitter().vm_mem_comm(fib_vm))


def test_vm_code_comm_matches_jax(fib_vm):
    code = fib_vm.elf.raw_code.bytes
    assert (commitments.ZkVmCommitter("cpu").vm_code_comm(code)
            == jax_comm.ZkVmCommitter().vm_code_comm(code))
    odd = bytes(code[:7])                  # a last odd byte is zero-padded
    assert (commitments.ZkVmCommitter("cpu").vm_code_comm(odd)
            == jax_comm.ZkVmCommitter().vm_code_comm(odd))


def test_incremental_mem_tree_matches_jax():
    vm = VM(256, 128).load_elf_data(fib_const_guest(0xC594BFC3))
    ours = commitments.IncrementalMemTree(vm, "cpu")
    theirs = JaxMemTree(vm)
    assert ours.levels == theirs.levels
    for page, word in ((17, 0xDEADBEEF), (0x11000 // 1024, 7), (127, 1)):
        vm.memory[page][4:8] = word.to_bytes(4, "little")
        ours.update_page(page)
        theirs.update_page(page)
        assert ours.root == theirs.root
        assert ours.open(page) == theirs.open(page)
    assert ours.levels == theirs.levels


@pytest.mark.cuda
def test_perm8_kernel_matches_twin_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x = port(states(8192, 5)).cuda()
    before = poseidon2.perm8.launches
    got = poseidon2.perm8(x)
    torch.cuda.synchronize()
    assert poseidon2.perm8.launches == before + 1
    assert torch.equal(got, poseidon2.perm8_twin(x))
    rows = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1 << 32, (300, 9), dtype=np.uint64).astype(np.int64))
    on_card = poseidon2.merkle_levels_rows(rows.cuda())
    on_cpu = poseidon2.merkle_levels_rows(rows)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
