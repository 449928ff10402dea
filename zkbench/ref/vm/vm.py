"""RV32IMAC virtual machine with per-instruction execution traces.

Mirrors the reference VM semantics exactly (latticeum/crates/vm/src/riscvm/
vm.rs:72-311, inst.rs:85-649): 32 u32 registers, paged word memory, monotonic
bump allocator behind ecall #1, LR/SC reservation, halt on jump-to-self, x0
pinned to zero after every step, per-step ExecutionTrace with input/output
snapshots and side effects (overflow flag, branch target, memory op — only
stores record memory ops, like the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .decoder import Inst, decode_stream
from .elf import Elf, load_elf, load_elf_bytes

M32 = 0xFFFFFFFF

# shared constants (configuration/src/lib.rs:3-6)
STACK_TOP = 0x0080_0000
RESULT_ADDRESS = 0x0
N_REGS = 32
WORD_SIZE = 4

WORDS_PER_PAGE_256 = 256
PAGE_COUNT_1024 = 1024
PAGE_COUNT_4096 = 4096
PAGE_COUNT_8192 = 8192
HEAP_START_1MB = 0x0002_0000
HEAP_END_1MB = 0x000F_0000
STACK_GUARD_BYTES = 0x0000_8000


def _s32(x):
    x &= M32
    return x - (1 << 32) if x & 0x80000000 else x


@dataclass
class MemoryOperation:
    cycle: int
    address: int
    value: int
    is_write: bool


@dataclass
class SideEffects:
    has_overflown: bool = False
    branched_to: int | None = None
    memory_op: MemoryOperation | None = None


@dataclass
class Snapshot:
    pc: int
    regs: list


@dataclass
class ExecutionTrace:
    cycle: int
    input: Snapshot
    output: Snapshot
    instruction: Inst
    side_effects: SideEffects = field(default_factory=SideEffects)


class HeapState:
    def __init__(self, start, end):
        assert start <= end
        self.start, self.end, self.next = start, end, start

    def alloc_aligned(self, size, align):
        if align == 0 or (align & (align - 1)) != 0:
            return None
        aligned = (self.next + align - 1) & ~(align - 1)
        new_next = aligned + size
        if new_next > self.end:
            return None
        self.next = new_next
        return aligned


class VM:
    def __init__(self, words_per_page=WORDS_PER_PAGE_256,
                 page_count=PAGE_COUNT_1024):
        self.words_per_page = words_per_page
        self.page_count = page_count
        self.regs = [0] * N_REGS
        self.pc = 0
        self.memory = [bytearray(4 * words_per_page) for _ in range(page_count)]
        self.heap = HeapState(HEAP_START_1MB, HEAP_END_1MB)
        self.reserved_word_addr = None
        self.elf: Elf | None = None
        self.instructions: dict[int, Inst] = {}

    # --- memory ----------------------------------------------------------
    def physical_addr(self, virt_addr):
        """(vm.rs:395-425)"""
        max_addr = self.words_per_page * self.page_count * WORD_SIZE
        assert virt_addr < max_addr, \
            f"Memory access out of bounds: {virt_addr:#x} >= {max_addr:#x}"
        assert virt_addr % WORD_SIZE == 0, \
            f"Unaligned memory access: {virt_addr}"
        word_bits = WORD_SIZE.bit_length() - 1
        page_index = virt_addr >> (self.words_per_page.bit_length() - 1 + word_bits)
        word_index = (virt_addr >> word_bits) & (self.words_per_page - 1)
        return page_index, word_index

    def read_mem(self, addr):
        p, w = self.physical_addr(addr)
        return int.from_bytes(self.memory[p][4 * w:4 * w + 4], "little")

    def write_mem(self, addr, value):
        p, w = self.physical_addr(addr)
        self.memory[p][4 * w:4 * w + 4] = (value & M32).to_bytes(4, "little")

    def memory_words(self):
        """All memory as a flat list of u32 words (page-major)."""
        out = []
        for page in self.memory:
            out.extend(int.from_bytes(page[4 * i:4 * i + 4], "little")
                       for i in range(self.words_per_page))
        return out

    def page_words(self, page_index):
        page = self.memory[page_index]
        return [int.from_bytes(page[4 * i:4 * i + 4], "little")
                for i in range(self.words_per_page)]

    # --- sub-word helpers (inst.rs:394-417) ------------------------------
    def _load_byte(self, addr):
        word = self.read_mem(addr & ~0b11)
        return (word >> ((addr & 0b11) * 8)) & 0xFF

    def _load_half(self, addr):
        return self._load_byte(addr) | (self._load_byte(addr + 1) << 8)

    def _store_byte(self, addr, value):
        wa = addr & ~0b11
        sh = (addr & 0b11) * 8
        word = (self.read_mem(wa) & ~(0xFF << sh)) | ((value & 0xFF) << sh)
        self.write_mem(wa, word)

    def _store_half(self, addr, value):
        self._store_byte(addr, value & 0xFF)
        self._store_byte(addr + 1, (value >> 8) & 0xFF)

    # --- registers -------------------------------------------------------
    def rr(self, r):
        return self.regs[r]

    def wr(self, r, v):
        self.regs[r] = v & M32

    # --- loading ---------------------------------------------------------
    def load_elf_file(self, path):
        return self.load_elf(load_elf(path))

    def load_elf_data(self, data: bytes):
        return self.load_elf(load_elf_bytes(data))

    def load_elf(self, elf: Elf):
        """(vm.rs:188-234)"""
        for addr, word in elf.image.items():
            self.write_mem(addr, word)
        image_end = (max(elf.image.keys()) + WORD_SIZE) if elf.image else 0
        heap_start = (image_end + 0xF) & ~0xF
        max_mem = WORD_SIZE * self.words_per_page * self.page_count
        heap_end = (STACK_TOP - STACK_GUARD_BYTES) if STACK_TOP <= max_mem \
            else max_mem
        self.heap = HeapState(min(heap_start, heap_end), heap_end)
        self.instructions = {}
        addr = elf.raw_code.start
        for inst in decode_stream(elf.raw_code.bytes, elf.raw_code.size):
            self.instructions[addr] = inst
            addr += inst.size
        self.pc = elf.entry_point
        self.elf = elf
        return self

    # --- execution -------------------------------------------------------
    def run(self, intercept=None, max_cycles=None, start_cycle=0):
        """(vm.rs:244-311): halt on jump-to-self or invalid pc."""
        cycle = start_cycle
        while True:
            inst = self.instructions.get(self.pc)
            if inst is None:
                break  # invalid PC halts (logged error in reference)
            trace = self.execute_step(inst, cycle)
            if intercept is not None:
                intercept(trace, self)
            if trace.input.pc == trace.output.pc:
                break
            cycle += 1
            if max_cycles is not None and cycle >= max_cycles:
                raise RuntimeError("max_cycles exceeded")

    def result(self):
        return self.read_mem(RESULT_ADDRESS)

    def execute_step(self, inst: Inst, cycle: int) -> ExecutionTrace:
        trace = ExecutionTrace(
            cycle=cycle,
            input=Snapshot(self.pc, list(self.regs)),
            output=Snapshot(0, [0] * N_REGS),
            instruction=inst,
        )
        se = trace.side_effects
        n = inst.name
        a = inst.args
        branched = False

        if n == "LUI":
            self.wr(a["rd"], a["imm"] << 12)
        elif n == "AUIPC":
            val = self.pc + ((a["imm"] << 12) & M32)
            se.has_overflown = val > M32
            self.wr(a["rd"], val)
        elif n == "JAL":
            link = (self.pc + inst.size) & M32
            new_pc = (self.pc + a["offset"]) & M32
            self.wr(a["rd"], link)
            self.pc = new_pc
            se.branched_to = new_pc
            branched = True
        elif n == "JALR":
            link = (self.pc + inst.size) & M32
            new_pc = (self.rr(a["rs1"]) + a["offset"]) & M32 & ~1
            self.pc = new_pc
            self.wr(a["rd"], link)
            se.branched_to = new_pc
            branched = True
        elif n in ("BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"):
            r1, r2 = self.rr(a["rs1"]), self.rr(a["rs2"])
            taken = {
                "BEQ": r1 == r2, "BNE": r1 != r2,
                "BLT": _s32(r1) < _s32(r2), "BGE": _s32(r1) >= _s32(r2),
                "BLTU": r1 < r2, "BGEU": r1 >= r2,
            }[n]
            if taken:
                new_pc = (self.pc + a["offset"]) & M32
                self.pc = new_pc
                se.branched_to = new_pc
            else:
                self.pc = (self.pc + inst.size) & M32
            branched = True
        elif n == "LW":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            self.wr(a["rd"], self.read_mem(addr))
        elif n == "LB":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            self.wr(a["rd"], _sext8(self._load_byte(addr)) & M32)
        elif n == "LBU":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            self.wr(a["rd"], self._load_byte(addr))
        elif n == "LH":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            self.wr(a["rd"], _sext16(self._load_half(addr)) & M32)
        elif n == "LHU":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            self.wr(a["rd"], self._load_half(addr))
        elif n == "SW":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            val = self.rr(a["rs2"])
            self.write_mem(addr, val)
            se.memory_op = MemoryOperation(cycle, addr, val, True)
        elif n == "SB":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            val = self.rr(a["rs2"]) & 0xFF
            self._store_byte(addr, val)
            se.memory_op = MemoryOperation(cycle, addr, val, True)
        elif n == "SH":
            addr = (self.rr(a["rs1"]) + a["offset"]) & M32
            val = self.rr(a["rs2"]) & 0xFFFF
            self._store_half(addr, val)
            se.memory_op = MemoryOperation(cycle, addr, val, True)
        elif n == "ADDI":
            v = _s32(self.rr(a["rs1"])) + a["imm"]
            se.has_overflown = not (-(1 << 31) <= v < (1 << 31))
            self.wr(a["rd"], v & M32)
        elif n == "SLTI":
            self.wr(a["rd"], int(_s32(self.rr(a["rs1"])) < a["imm"]))
        elif n == "SLTIU":
            self.wr(a["rd"], int(self.rr(a["rs1"]) < (a["imm"] & M32)))
        elif n == "XORI":
            self.wr(a["rd"], self.rr(a["rs1"]) ^ (a["imm"] & M32))
        elif n == "ORI":
            self.wr(a["rd"], self.rr(a["rs1"]) | (a["imm"] & M32))
        elif n == "ANDI":
            self.wr(a["rd"], self.rr(a["rs1"]) & (a["imm"] & M32))
        elif n == "SLLI":
            self.wr(a["rd"], self.rr(a["rs1"]) << a["shamt"])
        elif n == "SRLI":
            self.wr(a["rd"], self.rr(a["rs1"]) >> a["shamt"])
        elif n == "SRAI":
            self.wr(a["rd"], _s32(self.rr(a["rs1"])) >> a["shamt"] & M32)
        elif n == "ADD":
            v = self.rr(a["rs1"]) + self.rr(a["rs2"])
            se.has_overflown = v > M32
            self.wr(a["rd"], v)
        elif n == "SUB":
            self.wr(a["rd"], self.rr(a["rs1"]) - self.rr(a["rs2"]))
        elif n == "SLL":
            self.wr(a["rd"], self.rr(a["rs1"]) << (self.rr(a["rs2"]) & 0x1F))
        elif n == "SLT":
            self.wr(a["rd"], int(_s32(self.rr(a["rs1"])) < _s32(self.rr(a["rs2"]))))
        elif n == "SLTU":
            self.wr(a["rd"], int(self.rr(a["rs1"]) < self.rr(a["rs2"])))
        elif n == "XOR":
            self.wr(a["rd"], self.rr(a["rs1"]) ^ self.rr(a["rs2"]))
        elif n == "SRL":
            self.wr(a["rd"], self.rr(a["rs1"]) >> (self.rr(a["rs2"]) & 0x1F))
        elif n == "SRA":
            self.wr(a["rd"], _s32(self.rr(a["rs1"])) >> (self.rr(a["rs2"]) & 0x1F) & M32)
        elif n == "OR":
            self.wr(a["rd"], self.rr(a["rs1"]) | self.rr(a["rs2"]))
        elif n == "AND":
            self.wr(a["rd"], self.rr(a["rs1"]) & self.rr(a["rs2"]))
        elif n == "MUL":
            self.wr(a["rd"], self.rr(a["rs1"]) * self.rr(a["rs2"]))
        elif n == "MULHU":
            self.wr(a["rd"], (self.rr(a["rs1"]) * self.rr(a["rs2"])) >> 32)
        elif n == "DIVU":
            d = self.rr(a["rs2"])
            self.wr(a["rd"], M32 if d == 0 else self.rr(a["rs1"]) // d)
        elif n == "REMU":
            d = self.rr(a["rs2"])
            self.wr(a["rd"], self.rr(a["rs1"]) if d == 0 else self.rr(a["rs1"]) % d)
        elif n == "FENCE":
            pass
        elif n == "LR_W":
            addr = self.rr(a["rs1"])
            self.reserved_word_addr = addr
            self.wr(a["rd"], self.read_mem(addr))
        elif n == "SC_W":
            addr = self.rr(a["rs1"])
            if self.reserved_word_addr == addr:
                self.write_mem(addr, self.rr(a["rs2"]))
                self.wr(a["rd"], 0)
            else:
                self.wr(a["rd"], 1)
            self.reserved_word_addr = None
        elif n == "AMOADD_W":
            addr = self.rr(a["rs1"])
            old = self.read_mem(addr)
            self.write_mem(addr, old + self.rr(a["rs2"]))
            self.wr(a["rd"], old)
            self.reserved_word_addr = None
        elif n == "ECALL":
            if self.rr(17) == 1:  # SYSCALL_ALLOC_ALIGNED
                ptr = self.heap.alloc_aligned(self.rr(10), self.rr(11))
                self.wr(10, ptr if ptr is not None else 0)
            else:
                raise RuntimeError(f"unsupported syscall {self.rr(17)}")
        elif n == "UNIMP":
            raise RuntimeError(
                f"hit UNIMP at pc={self.pc:#x}, cycle={cycle}")
        else:
            raise RuntimeError(f"unsupported instruction {n} at {self.pc:#x}")

        if not branched:
            self.pc = (self.pc + inst.size) & M32
        trace.output.pc = self.pc
        trace.output.regs = list(self.regs)
        self.wr(0, 0)
        return trace


def _sext8(v):
    return v - 256 if v & 0x80 else v


def _sext16(v):
    return v - (1 << 16) if v & 0x8000 else v


def new_vm_1mb():
    return VM(WORDS_PER_PAGE_256, PAGE_COUNT_1024)


def new_vm_4mb():
    return VM(WORDS_PER_PAGE_256, PAGE_COUNT_4096)


def new_vm_8mb():
    return VM(WORDS_PER_PAGE_256, PAGE_COUNT_8192)
