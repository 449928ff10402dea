"""Tiny RV32I assembler + ELF32 writer for building test/bench guests.

The reference's guests are Rust no_std binaries (latticeum/crates/guest,
guests/fibonacci); without a Rust cross toolchain we synthesize equivalent
guests directly.  Only the 4-byte encodings are emitted (the decoder and VM
handle compressed forms produced by real toolchains)."""

from __future__ import annotations

import struct

M32 = 0xFFFFFFFF


def _u(v, bits):
    v &= (1 << bits) - 1
    return v


def lui(rd, imm20):
    return (_u(imm20, 20) << 12) | (rd << 7) | 0x37


def auipc(rd, imm20):
    return (_u(imm20, 20) << 12) | (rd << 7) | 0x17


def jal(rd, offset):
    imm = _u(offset, 21)
    w = ((imm >> 20) & 1) << 31 | ((imm >> 1) & 0x3FF) << 21 | \
        ((imm >> 11) & 1) << 20 | ((imm >> 12) & 0xFF) << 12 | (rd << 7) | 0x6F
    return w


def jalr(rd, rs1, offset):
    return (_u(offset, 12) << 20) | (rs1 << 15) | (rd << 7) | 0x67


def _btype(f3, rs1, rs2, offset):
    imm = _u(offset, 13)
    return ((imm >> 12) & 1) << 31 | ((imm >> 5) & 0x3F) << 25 | \
        (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        ((imm >> 1) & 0xF) << 8 | ((imm >> 11) & 1) << 7 | 0x63


def beq(rs1, rs2, offset):
    return _btype(0b000, rs1, rs2, offset)


def bne(rs1, rs2, offset):
    return _btype(0b001, rs1, rs2, offset)


def bltu(rs1, rs2, offset):
    return _btype(0b110, rs1, rs2, offset)


def addi(rd, rs1, imm):
    return (_u(imm, 12) << 20) | (rs1 << 15) | (rd << 7) | 0x13


def _rtype(f7, f3, rd, rs1, rs2):
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | 0x33


def add(rd, rs1, rs2):
    return _rtype(0, 0, rd, rs1, rs2)


def sub(rd, rs1, rs2):
    return _rtype(0x20, 0, rd, rs1, rs2)


def mul(rd, rs1, rs2):
    return _rtype(1, 0, rd, rs1, rs2)


def sw(rs1, rs2, offset):
    imm = _u(offset, 12)
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (0b010 << 12) | \
        ((imm & 0x1F) << 7) | 0x23


def lw(rd, rs1, offset):
    return (_u(offset, 12) << 20) | (rs1 << 15) | (0b010 << 12) | (rd << 7) | 0x03


def li32(rd, value):
    """Load a full 32-bit constant: lui + addi (2 instructions)."""
    value &= M32
    lo = value & 0xFFF
    if lo >= 0x800:
        lo -= 0x1000
    hi = ((value - lo) >> 12) & 0xFFFFF
    return [lui(rd, hi), addi(rd, rd, lo)]


def write_elf(words: list[int], entry: int, base: int = 0x11000) -> bytes:
    """Single executable PT_LOAD segment at `base` containing `words`."""
    code = b"".join(struct.pack("<I", w & M32) for w in words)
    ehsize, phentsize = 52, 32
    phoff = ehsize
    code_off = ehsize + phentsize
    eh = struct.pack(
        "<4sBBBBB7xHHIIIIIHHHHHH",
        b"\x7fELF", 1, 1, 1, 0, 0,           # ELF32 LE
        2, 243, 1,                            # EXEC, RISC-V, v1
        entry, phoff, 0, 0,
        ehsize, phentsize, 1,                 # one program header
        0, 0, 0)
    ph = struct.pack("<IIIIIIII", 1, code_off, base, base,
                     len(code), len(code), 0x5, 4)  # PT_LOAD, R+X
    return eh + ph + code


def fib_const_guest(result: int, base: int = 0x11000) -> bytes:
    """Guest mirroring the reference fib-100 shape: the compiler const-folds
    fib(100), so the binary just stores 0xc594bfc3 and halts
    (guests/fibonacci/src/main.rs + crates/guest _start)."""
    # layout: _start at entry: set gp/sp, call main; main: li result, sw, ret;
    # halt: jal 0 (jump-to-self)
    words = []
    # main (offset 0): li a0, result; sw a0, 0(zero); ret
    words += li32(10, result)
    words += [sw(0, 10, 0), jalr(0, 1, 0)]
    main_off = 0
    # _start (offset 20):
    start_off = len(words) * 4
    words += [
        lui(3, 0x11),                 # gp = 0x11000 (dummy global pointer)
        lui(2, 0x800),                # sp = STACK_TOP = 0x0080_0000
        auipc(1, 0),                  # ra = pc
        jalr(1, 1, (main_off - (start_off + 8))),  # call main
        jal(0, 0),                    # halt: jump-to-self
    ]
    return write_elf(words, base + start_off, base)


def fib_loop_guest(n: int, base: int = 0x11000) -> bytes:
    """Guest computing fib(n) with a loop (n+~10 traces) — the analog of the
    committed fibonacci_100_000 sample's main loop."""
    words = []
    # main: a0=0 (fib0), a1=1 (fib1), a2=n
    main = len(words)
    words += [addi(10, 0, 0), addi(11, 0, 1)]
    words += li32(12, n)
    # loop: t0 = a0+a1; a0 = a1; a1 = t0; a2 -= 1; bne a2, x0, loop
    loop_off = len(words) * 4
    words += [
        add(5, 10, 11),
        add(10, 0, 11),
        add(11, 0, 5),
        addi(12, 12, -1),
    ]
    words += [bne(12, 0, loop_off - len(words) * 4)]
    # store fib(n) (in a0 after n iterations fib moves ahead; store a0)
    words += [sw(0, 10, 0), jal(0, 0)]
    entry_off = main * 4
    return write_elf(words, base + entry_off, base)


def mem_churn_guest(pages: int = 64, passes: int = 2, stride: int = 256,
                    base: int = 0x11000) -> bytes:
    """Memory-heavy guest: strided read-modify-write sweeps over `pages`
    4 KiB pages of RAM (the paged-RAM-churn substitute for the reference's
    EVM guest workload, guests/evm/src/main.rs) — every sweep touches every
    page, so each step's Merkle mem-tree update path is exercised under
    churn.  Trace count ~= pages * (4096/stride) * passes * 4 + O(10)."""
    words = []
    # a0 = cursor, a1 = end, a2 = passes, t0 = scratch
    heap = 0x40000                        # past code+stack, page-aligned
    words += li32(12, passes)
    pass_off = len(words) * 4
    words += li32(10, heap)
    words += li32(11, heap + pages * 4096)
    loop_off = len(words) * 4
    words += [
        lw(5, 10, 0),                     # t0 = mem[cursor]
        add(5, 5, 10),                    # t0 += cursor
        sw(10, 5, 0),                     # mem[cursor] = t0
        addi(10, 10, stride),             # cursor += stride
    ]
    words += [bltu(10, 11, loop_off - len(words) * 4)]
    words += [addi(12, 12, -1)]
    words += [bne(12, 0, pass_off - len(words) * 4)]
    # result = checksum word of the last page
    words += [lw(10, 11, -stride), sw(0, 10, 0), jal(0, 0)]
    return write_elf(words, base, base)


# ---------------------------------------------------------------------------
# Two-pass text assembler with labels
# ---------------------------------------------------------------------------

_ABI_REGS = {"zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "fp": 8}
_ABI_REGS.update({f"t{i}": r for i, r in
                  enumerate([5, 6, 7, 28, 29, 30, 31])})
_ABI_REGS.update({f"s{i}": r for i, r in
                  enumerate([8, 9, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27])})
_ABI_REGS.update({f"a{i}": 10 + i for i in range(8)})
_ABI_REGS.update({f"x{i}": i for i in range(32)})


def _reg(tok: str) -> int:
    try:
        return _ABI_REGS[tok.strip().lower()]
    except KeyError:
        raise ValueError(f"unknown register {tok!r}") from None


def _itype(f3, rd, rs1, imm, op=0x13):
    return (_u(imm, 12) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def _store(f3, rs1, rs2, offset):
    imm = _u(offset, 12)
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | \
        ((imm & 0x1F) << 7) | 0x23


# name -> (kind, encoder extras).  kinds: R (rd,rs1,rs2), I (rd,rs1,imm),
# SH (rd,rs1,shamt), L (rd, off(rs1)), S (rs2, off(rs1)), B (rs1,rs2,label),
# U (rd,imm20), J (rd,label)
_INSTS = {
    # R-type: (funct7, funct3)
    "add": ("R", 0x00, 0), "sub": ("R", 0x20, 0), "sll": ("R", 0x00, 1),
    "slt": ("R", 0x00, 2), "sltu": ("R", 0x00, 3), "xor": ("R", 0x00, 4),
    "srl": ("R", 0x00, 5), "sra": ("R", 0x20, 5), "or": ("R", 0x00, 6),
    "and": ("R", 0x00, 7),
    "mul": ("R", 0x01, 0), "mulhu": ("R", 0x01, 3),
    "divu": ("R", 0x01, 5), "remu": ("R", 0x01, 7),
    # I-type arithmetic
    "addi": ("I", 0), "slti": ("I", 2), "sltiu": ("I", 3), "xori": ("I", 4),
    "ori": ("I", 6), "andi": ("I", 7),
    # shifts (immediate)
    "slli": ("SH", 0x00, 1), "srli": ("SH", 0x00, 5), "srai": ("SH", 0x20, 5),
    # loads / stores
    "lb": ("L", 0), "lh": ("L", 1), "lw": ("L", 2), "lbu": ("L", 4),
    "lhu": ("L", 5),
    "sb": ("S", 0), "sh": ("S", 1), "sw": ("S", 2),
    # branches
    "beq": ("B", 0), "bne": ("B", 1), "blt": ("B", 4), "bge": ("B", 5),
    "bltu": ("B", 6), "bgeu": ("B", 7),
    # upper / jumps
    "lui": ("U",), "auipc": ("U",), "jal": ("J",), "jalr": ("JR",),
    "ecall": ("E",),
}


def _imm(tok: str, labels=None, pc=None) -> int:
    tok = tok.strip()
    if labels is not None and tok in labels:
        return labels[tok] - (pc if pc is not None else 0)
    return int(tok, 0)


def _li_words(value: int) -> int:
    """Instruction count of `li` for this value (stable across passes)."""
    value &= M32
    if value < 0x800 or value >= (M32 + 1 - 0x800):
        return 1
    return 2


def asm(source: str, base: int = 0x11000):
    """Assemble label-based RV32IM text into a word list.

    Supports the full instruction set the VM implements (rv32i + mul/mulhu/
    divu/remu + ecall; vm.py execute_step), ABI register names, `#`
    comments, and the pseudo-instructions:
      li rd, imm        (addi or lui+addi)
      mv rd, rs         (addi rd, rs, 0)
      not/neg, j label, jr rs, ret, call label, nop, halt (jump-to-self)
      .word <value>
    Branch/jump targets are labels; two passes resolve them exactly.
    """
    lines = []
    for raw in source.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        while ":" in line:
            lbl, line = line.split(":", 1)
            lines.append((lbl.strip(), None))
            line = line.strip()
        if line:
            mnem, _, rest = line.partition(" ")
            args = [a.strip() for a in rest.replace(",", " ").split()] \
                if rest.strip() else []
            lines.append((None, (mnem.lower(), args)))

    # pass 1: label addresses (every instruction 4 bytes; li sized by value)
    labels = {}
    pc = 0
    for lbl, ins in lines:
        if lbl is not None:
            labels[lbl] = pc
            continue
        mnem, args = ins
        if mnem == "li":
            pc += 4 * _li_words(_imm(args[1]))
        elif mnem == "call":
            pc += 4
        else:
            pc += 4

    # pass 2: encode
    words = []
    pc = 0
    for lbl, ins in lines:
        if lbl is not None:
            continue
        mnem, args = ins
        # pseudo-instructions
        if mnem == "nop":
            mnem, args = "addi", ["x0", "x0", "0"]
        elif mnem == "mv":
            mnem, args = "addi", [args[0], args[1], "0"]
        elif mnem == "not":
            mnem, args = "xori", [args[0], args[1], "-1"]
        elif mnem == "neg":
            mnem, args = "sub", [args[0], "x0", args[1]]
        elif mnem == "j":
            mnem, args = "jal", ["x0", args[0]]
        elif mnem == "jr":
            mnem, args = "jalr", ["x0", args[0], "0"]
        elif mnem == "ret":
            mnem, args = "jalr", ["x0", "ra", "0"]
        elif mnem == "call":
            mnem, args = "jal", ["ra", args[0]]
        elif mnem == "halt":
            words.append(jal(0, 0))
            pc += 4
            continue
        elif mnem == "li":
            rd = _reg(args[0])
            value = _imm(args[1]) & M32
            if _li_words(value) == 1:
                words.append(addi(rd, 0, value & 0xFFF))
            else:
                words.extend(li32(rd, value))
                pc += 4
            pc += 4
            continue
        elif mnem == ".word":
            words.append(_imm(args[0]) & M32)
            pc += 4
            continue

        spec = _INSTS.get(mnem)
        if spec is None:
            raise ValueError(f"unknown mnemonic {mnem!r}")
        kind = spec[0]
        if kind == "R":
            words.append(_rtype(spec[1], spec[2], _reg(args[0]),
                                _reg(args[1]), _reg(args[2])))
        elif kind == "I":
            words.append(_itype(spec[1], _reg(args[0]), _reg(args[1]),
                                _imm(args[2])))
        elif kind == "SH":
            words.append((spec[1] << 25) | (_u(_imm(args[2]), 5) << 20)
                         | (_reg(args[1]) << 15) | (spec[2] << 12)
                         | (_reg(args[0]) << 7) | 0x13)
        elif kind in ("L", "S"):
            # "lw rd, off(rs1)" or "lw rd, rs1, off"
            if len(args) == 2 and "(" in args[1]:
                off, rs1 = args[1].rstrip(")").split("(")
                off = _imm(off) if off else 0
                rs1 = _reg(rs1)
            else:
                rs1, off = _reg(args[1]), _imm(args[2])
            if kind == "L":
                words.append(_itype(spec[1], _reg(args[0]), rs1, off,
                                    op=0x03))
            else:
                words.append(_store(spec[1], rs1, _reg(args[0]), off))
        elif kind == "B":
            words.append(_btype(spec[1], _reg(args[0]), _reg(args[1]),
                                _imm(args[2], labels, pc)))
        elif kind == "U":
            enc = lui if mnem == "lui" else auipc
            words.append(enc(_reg(args[0]), _imm(args[1])))
        elif kind == "J":
            words.append(jal(_reg(args[0]), _imm(args[1], labels, pc)))
        elif kind == "JR":
            words.append(jalr(_reg(args[0]), _reg(args[1]),
                              _imm(args[2]) if len(args) > 2 else 0))
        elif kind == "E":
            words.append(0x73)
        pc += 4
    return words


def asm_guest(source: str, base: int = 0x11000, entry_label: str = "_start"
              ) -> bytes:
    """Assemble a labeled source into a loadable ELF guest."""
    words = asm(source, base)
    # recompute label table for the entry point
    labels = {}
    pc = 0
    for raw in source.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        while ":" in line:
            lbl, line = line.split(":", 1)
            labels[lbl.strip()] = pc
            line = line.strip()
        if line:
            mnem = line.split()[0].lower()
            if mnem == "li":
                val = line.replace(",", " ").split()[-1]
                pc += 4 * _li_words(int(val, 0))
            else:
                pc += 4
    entry = base + labels.get(entry_label, 0)
    return write_elf(words, entry, base)


XORSHIFT_GUEST = """
# Real multi-function guest: xorshift32 PRNG fills a buffer (subroutine),
# then a second pass folds it into a mixing checksum (subroutine with its
# own loop), result stored at RESULT_ADDRESS (0x0).  Exercises call/ret,
# nested loops, all shift/logic ops, mul, and sub-word stores.
_start:
    lui   gp, 0x11
    lui   sp, 0x800          # STACK_TOP = 0x0080_0000
    li    s0, 0x40000        # buffer base
    li    s1, NWORDS         # word count
    li    a0, 0x12345678     # seed
    mv    a1, s0
    mv    a2, s1
    call  fill
    mv    a0, s0
    mv    a1, s1
    call  checksum
    sw    a0, 0(zero)        # result
    halt

# fill(a0=seed, a1=buf, a2=n): xorshift32 stream into buf
fill:
fill_loop:
    slli  t0, a0, 13
    xor   a0, a0, t0
    srli  t0, a0, 17
    xor   a0, a0, t0
    slli  t0, a0, 5
    xor   a0, a0, t0
    sw    a0, 0(a1)
    addi  a1, a1, 4
    addi  a2, a2, -1
    bne   a2, zero, fill_loop
    ret

# checksum(a0=buf, a1=n) -> a0: multiply-mix fold
checksum:
    li    t1, 0x01000193     # FNV-ish prime
    li    t2, 0x811C9DC5     # basis
cs_loop:
    lw    t0, 0(a0)
    xor   t2, t2, t0
    mul   t2, t2, t1
    srli  t3, t2, 15
    xor   t2, t2, t3
    addi  a0, a0, 4
    addi  a1, a1, -1
    bne   a1, zero, cs_loop
    mv    a0, t2
    ret
"""


def xorshift_guest(n_words: int = 64, base: int = 0x11000) -> bytes:
    """The assembler-built real-program guest; ~26*n+20 trace steps."""
    return asm_guest(XORSHIFT_GUEST.replace("NWORDS", str(n_words)), base)


def xorshift_guest_expected(n_words: int = 64) -> int:
    """Python model of XORSHIFT_GUEST's result (independent oracle)."""
    s = 0x12345678
    buf = []
    for _ in range(n_words):
        s ^= (s << 13) & M32
        s ^= s >> 17
        s ^= (s << 5) & M32
        buf.append(s)
    h = 0x811C9DC5
    for w in buf:
        h = ((h ^ w) * 0x01000193) & M32
        h ^= h >> 15
    return h
