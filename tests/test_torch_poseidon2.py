"""The port's Poseidon2 width-8 (crypto/poseidon2.py) and the trees built on
it (zkvm/commitments.py) against the JAX package.

perm8's plain-torch twin is held against the JAX package's batched
``crypto/poseidon2.perm8`` on the numpy backend (the plain reference the
Pallas kernel ``parallel/pallas_kernels.py:109`` was checked against on the
TPU) and against the scalar oracle ``poseidon2_ref.perm8``; the Merkle
levels, the memory and code roots and IncrementalMemTree against the JAX
package's host trees.  The sponge's twin (``sponge8_twin``, the plain
version of the one-launch ``sponge8``) is held against the JAX package's
``hash_rows_narrow`` and ``poseidon2_ref.hash_narrow``.  Tolerance: none
(exact integers).  The CUDA kernels, every form of each, are checked
against the twins on the card (``cuda`` marker)."""

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


SPONGE_SHAPES = [(1, 1), (3, 7), (6, 9), (16, 256), (300, 1)]


def sponge_rows(n, length):
    """(n, L) field values: u32 words, the first words of the first rows
    each edge value four times in a row (so in every rate position)."""
    rng = np.random.default_rng(n * 1000 + length)
    u = rng.integers(0, 1 << 32, (n, length), dtype=np.uint64)
    edges = np.repeat(np.array(EDGES, np.uint64), 4)[:u.size]
    u.reshape(-1)[:edges.size] = edges
    return u


@pytest.mark.parametrize("reference", ["jax_batched", "scalar_oracle"])
@pytest.mark.parametrize("shape", SPONGE_SHAPES)
def test_sponge8_twin_matches_reference(shape, reference):
    u = sponge_rows(*shape)
    got = gl.to_int_lists(poseidon2.sponge8_twin(port(u)))
    if reference == "jax_batched":
        with B.numpy_mode():
            lo, hi = p2_jax.hash_rows_narrow(u)
        want = gl_ref.to_int((np.asarray(lo), np.asarray(hi)))
        want = [[int(v) for v in row] for row in want]
    else:
        want = [p2_ref.hash_narrow([int(v) for v in row]) for row in u]
    assert got == want


def test_sponge8_on_cpu_is_its_twin_and_checks_its_input():
    u = sponge_rows(5, 9)
    want = poseidon2.sponge8_twin(port(u))
    assert torch.equal(poseidon2.sponge8(port(u)), want)
    assert torch.equal(poseidon2.hash_rows_narrow(port(u)), want)
    for lanes in poseidon2.LANES:
        assert torch.equal(poseidon2.sponge8_lanes(port(u), lanes), want)
    assert poseidon2.sponge8(torch.zeros((0, 4), dtype=torch.int64)).shape \
        == (0, 4)
    empty_rows = torch.zeros((2, 0), dtype=torch.int64)
    assert torch.equal(poseidon2.sponge8(empty_rows),
                       torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        poseidon2.sponge8(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        poseidon2.sponge8(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        poseidon2.sponge8(torch.zeros((8, 4), dtype=torch.int64).T)
    with pytest.raises(ValueError):
        poseidon2.sponge8_lanes(port(u), 3)


def test_perm8_forms_on_cpu_are_the_twin():
    u = states(9, 4)
    want = poseidon2.perm8_twin(port(u))
    for lanes in poseidon2.LANES:
        assert torch.equal(poseidon2.perm8_lanes(port(u), lanes), want)
    with pytest.raises(ValueError):
        poseidon2.perm8_lanes(port(u), 16)


@pytest.mark.parametrize("n, lanes", [(1, 8), (512, 8), (1024, 8), (2048, 8),
                                      (4096, 4), (8192, 2), (16384, 2),
                                      (65536, 1), (524288, 1)])
def test_kernel_lanes_is_the_measured_fastest(n, lanes):
    """The fastest S at each shape measured on the H100 (PERF.md)."""
    assert poseidon2.kernel_lanes(n) == lanes
    assert lanes in poseidon2.LANES


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


def test_incremental_mem_tree_records_its_parts(fib_vm):
    timings = {}
    tree = commitments.IncrementalMemTree(fib_vm, "cpu", timings=timings)
    assert tree.root == JaxMemTree(fib_vm).root
    assert sorted(timings) == sorted(
        "trees." + part for part in commitments.IncrementalMemTree.PARTS)
    assert all(len(v) == 1 and v[0] >= 0 for v in timings.values())


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_perm8_kernel_matches_twin_on_cuda():
    need_card()
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1023, 8192])
@pytest.mark.parametrize("lanes", poseidon2.LANES)
def test_perm8_form_matches_twin_on_cuda(lanes, n):
    need_card()
    x = port(states(n, n)).cuda()
    before = poseidon2.perm8.launches
    got = poseidon2.perm8_lanes(x, lanes)
    torch.cuda.synchronize()
    assert poseidon2.perm8.launches == before + 1
    assert torch.equal(got, poseidon2.perm8_twin(x))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", poseidon2.LANES)
def test_perm8_form_edge_values_each_position_on_cuda(lanes):
    need_card()
    u = np.zeros((8 * len(EDGES), 8), np.uint64)
    for i, v in enumerate(EDGES):
        for lane in range(8):
            u[8 * i + lane, lane] = v
    got = gl.to_int_lists(poseidon2.perm8_lanes(port(u).cuda(), lanes))
    assert got == [p2_ref.perm8([int(v) for v in row]) for row in u]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SPONGE_SHAPES + [(33, 5), (1023, 12)])
@pytest.mark.parametrize("lanes", poseidon2.LANES)
def test_sponge8_form_matches_twin_on_cuda(lanes, shape):
    need_card()
    x = port(sponge_rows(*shape)).cuda()
    before = poseidon2.sponge8.launches
    got = poseidon2.sponge8_lanes(x, lanes)
    torch.cuda.synchronize()
    assert poseidon2.sponge8.launches == before + 1
    assert torch.equal(got, poseidon2.sponge8_twin(x))


@pytest.mark.cuda
def test_trees_count_their_launches_on_cuda():
    """A tree of n rows: one sponge launch, log2(n) perm8 launches."""
    need_card()
    rows = port(sponge_rows(1024, 256)).cuda()
    sponge0, perm0 = poseidon2.sponge8.launches, poseidon2.perm8.launches
    levels = poseidon2.merkle_levels_rows(rows)
    torch.cuda.synchronize()
    assert poseidon2.sponge8.launches == sponge0 + 1
    assert poseidon2.perm8.launches == perm0 + 10
    assert len(levels) == 11
