"""RV32IMAC instruction decoder.

Decodes 32-bit standard and 16-bit compressed instructions into expanded base
forms (compressed C.ADD becomes ADD with size 2, etc.), matching the behavior
of the reference's riscv-isa wrapper (latticeum/crates/vm/src/riscvm/
inst_decoder.rs:8-113, incl. its compressed SUB/XOR/OR/AND handling).

Immediate conventions follow the reference trace layout:
  * LUI/AUIPC carry the UNshifted 20-bit immediate (executor shifts by 12);
  * branch/jump offsets are byte offsets relative to the instruction.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Inst:
    name: str
    raw_word: int
    size: int
    args: dict = field(default_factory=dict, compare=True, hash=False)

    def __getattr__(self, k):
        try:
            return self.args[k]
        except KeyError:
            raise AttributeError(k)

    def __repr__(self):
        a = ", ".join(f"{k}={v}" for k, v in self.args.items())
        return f"{self.name}({a}) size={self.size} raw={self.raw_word:#x}"


def _sext(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    if value & (1 << (bits - 1)):
        value -= 1 << bits
    return value


BRANCHES = {0b000: "BEQ", 0b001: "BNE", 0b100: "BLT", 0b101: "BGE",
            0b110: "BLTU", 0b111: "BGEU"}
LOADS = {0b000: "LB", 0b001: "LH", 0b010: "LW", 0b100: "LBU", 0b101: "LHU"}
STORES = {0b000: "SB", 0b001: "SH", 0b010: "SW"}
ALU_IMM = {0b000: "ADDI", 0b010: "SLTI", 0b011: "SLTIU", 0b100: "XORI",
           0b110: "ORI", 0b111: "ANDI"}
ALU_REG = {(0, 0b000): "ADD", (0x20, 0b000): "SUB", (0, 0b001): "SLL",
           (0, 0b010): "SLT", (0, 0b011): "SLTU", (0, 0b100): "XOR",
           (0, 0b101): "SRL", (0x20, 0b101): "SRA", (0, 0b110): "OR",
           (0, 0b111): "AND"}
MUL_DIV = {0b000: "MUL", 0b001: "MULH", 0b010: "MULHSU", 0b011: "MULHU",
           0b100: "DIV", 0b101: "DIVU", 0b110: "REM", 0b111: "REMU"}
AMO = {0b00010: "LR_W", 0b00011: "SC_W", 0b00000: "AMOADD_W",
       0b00001: "AMOSWAP_W"}


def decode_word(w: int) -> Inst:
    """Decode a full 32-bit instruction word."""
    op = w & 0x7F
    rd = (w >> 7) & 0x1F
    f3 = (w >> 12) & 0x7
    rs1 = (w >> 15) & 0x1F
    rs2 = (w >> 20) & 0x1F
    f7 = (w >> 25) & 0x7F

    def mk(name, **args):
        return Inst(name, w, 4, args)

    if op == 0x37:
        return mk("LUI", rd=rd, imm=(w >> 12) & 0xFFFFF)
    if op == 0x17:
        return mk("AUIPC", rd=rd, imm=(w >> 12) & 0xFFFFF)
    if op == 0x6F:
        imm = (((w >> 31) & 1) << 20) | (((w >> 12) & 0xFF) << 12) | \
              (((w >> 20) & 1) << 11) | (((w >> 21) & 0x3FF) << 1)
        return mk("JAL", rd=rd, offset=_sext(imm, 21))
    if op == 0x67 and f3 == 0:
        return mk("JALR", rd=rd, rs1=rs1, offset=_sext(w >> 20, 12))
    if op == 0x63 and f3 in BRANCHES:
        imm = (((w >> 31) & 1) << 12) | (((w >> 7) & 1) << 11) | \
              (((w >> 25) & 0x3F) << 5) | (((w >> 8) & 0xF) << 1)
        return mk(BRANCHES[f3], rs1=rs1, rs2=rs2, offset=_sext(imm, 13))
    if op == 0x03 and f3 in LOADS:
        return mk(LOADS[f3], rd=rd, rs1=rs1, offset=_sext(w >> 20, 12))
    if op == 0x23 and f3 in STORES:
        imm = ((w >> 25) << 5) | ((w >> 7) & 0x1F)
        return mk(STORES[f3], rs1=rs1, rs2=rs2, offset=_sext(imm, 12))
    if op == 0x13:
        if f3 == 0b001 and f7 == 0:
            return mk("SLLI", rd=rd, rs1=rs1, shamt=rs2)
        if f3 == 0b101 and f7 == 0:
            return mk("SRLI", rd=rd, rs1=rs1, shamt=rs2)
        if f3 == 0b101 and f7 == 0x20:
            return mk("SRAI", rd=rd, rs1=rs1, shamt=rs2)
        if f3 in ALU_IMM:
            return mk(ALU_IMM[f3], rd=rd, rs1=rs1, imm=_sext(w >> 20, 12))
    if op == 0x33:
        if f7 == 1 and f3 in MUL_DIV:
            return mk(MUL_DIV[f3], rd=rd, rs1=rs1, rs2=rs2)
        if (f7, f3) in ALU_REG:
            return mk(ALU_REG[(f7, f3)], rd=rd, rs1=rs1, rs2=rs2)
    if op == 0x0F:
        return mk("FENCE")
    if op == 0x73:
        if w == 0x00000073:
            return mk("ECALL")
        if w == 0x00100073:
            return mk("EBREAK")
    if op == 0x2F and f3 == 0b010:
        f5 = (w >> 27) & 0x1F
        if f5 in AMO:
            return mk(AMO[f5], rd=rd, rs1=rs1, rs2=rs2)
    return mk("UNIMP")


def decode_compressed(h: int) -> Inst:
    """Decode a 16-bit compressed instruction into its expanded base form."""
    q = h & 0b11
    f3 = (h >> 13) & 0b111

    def mk(name, **args):
        return Inst(name, h, 2, args)

    rdp = ((h >> 2) & 0b111) + 8   # rd'/rs2' (bits 4:2)
    rs1p = ((h >> 7) & 0b111) + 8  # rs1'/rd' (bits 9:7)
    rd_full = (h >> 7) & 0x1F
    rs2_full = (h >> 2) & 0x1F

    if q == 0b00:
        if f3 == 0b000 and h != 0:
            # C.ADDI4SPN: nzuimm[5:4|9:6|2|3]
            imm = (((h >> 7) & 0xF) << 6) | (((h >> 11) & 0x3) << 4) | \
                  (((h >> 5) & 1) << 3) | (((h >> 6) & 1) << 2)
            if imm:
                return mk("ADDI", rd=rdp, rs1=2, imm=imm)
        if f3 == 0b010:
            imm = (((h >> 5) & 1) << 6) | (((h >> 10) & 0x7) << 3) | \
                  (((h >> 6) & 1) << 2)
            return mk("LW", rd=rdp, rs1=rs1p, offset=imm)
        if f3 == 0b110:
            imm = (((h >> 5) & 1) << 6) | (((h >> 10) & 0x7) << 3) | \
                  (((h >> 6) & 1) << 2)
            return mk("SW", rs1=rs1p, rs2=rdp, offset=imm)
        return mk("UNIMP")

    if q == 0b01:
        imm6 = _sext((((h >> 12) & 1) << 5) | ((h >> 2) & 0x1F), 6)
        if f3 == 0b000:
            return mk("ADDI", rd=rd_full, rs1=rd_full, imm=imm6)
        if f3 == 0b001 or f3 == 0b101:
            # C.JAL / C.J: offset[11|4|9:8|10|6|7|3:1|5]
            imm = (((h >> 12) & 1) << 11) | (((h >> 11) & 1) << 4) | \
                  (((h >> 9) & 0x3) << 8) | (((h >> 8) & 1) << 10) | \
                  (((h >> 7) & 1) << 6) | (((h >> 6) & 1) << 7) | \
                  (((h >> 3) & 0x7) << 1) | (((h >> 2) & 1) << 5)
            off = _sext(imm, 12)
            return mk("JAL", rd=(1 if f3 == 0b001 else 0), offset=off)
        if f3 == 0b010:
            return mk("ADDI", rd=rd_full, rs1=0, imm=imm6)
        if f3 == 0b011:
            if rd_full == 2:
                # C.ADDI16SP: nzimm[9|4|6|8:7|5]
                imm = (((h >> 12) & 1) << 9) | (((h >> 6) & 1) << 4) | \
                      (((h >> 5) & 1) << 6) | (((h >> 3) & 0x3) << 7) | \
                      (((h >> 2) & 1) << 5)
                return mk("ADDI", rd=2, rs1=2, imm=_sext(imm, 10))
            return mk("LUI", rd=rd_full, imm=imm6 & 0xFFFFF)
        if f3 == 0b100:
            b11_10 = (h >> 10) & 0b11
            if b11_10 == 0b00:
                return mk("SRLI", rd=rs1p, rs1=rs1p, shamt=imm6 & 0x3F)
            if b11_10 == 0b01:
                return mk("SRAI", rd=rs1p, rs1=rs1p, shamt=imm6 & 0x3F)
            if b11_10 == 0b10:
                return mk("ANDI", rd=rs1p, rs1=rs1p, imm=imm6)
            # register ops (inst_decoder.rs:42-65 fallback territory)
            b6_5 = (h >> 5) & 0b11
            b12 = (h >> 12) & 1
            names = {0b00: "SUB", 0b01: "XOR", 0b10: "OR", 0b11: "AND"}
            if b12 == 0:
                return mk(names[b6_5], rd=rs1p, rs1=rs1p, rs2=rdp)
            return mk("UNIMP")
        if f3 == 0b110 or f3 == 0b111:
            # C.BEQZ / C.BNEZ: offset[8|4:3|7:6|2:1|5]
            imm = (((h >> 12) & 1) << 8) | (((h >> 10) & 0x3) << 3) | \
                  (((h >> 5) & 0x3) << 6) | (((h >> 3) & 0x3) << 1) | \
                  (((h >> 2) & 1) << 5)
            off = _sext(imm, 9)
            name = "BEQ" if f3 == 0b110 else "BNE"
            return mk(name, rs1=rs1p, rs2=0, offset=off)
        return mk("UNIMP")

    # q == 0b10
    if f3 == 0b000:
        shamt = (((h >> 12) & 1) << 5) | ((h >> 2) & 0x1F)
        return mk("SLLI", rd=rd_full, rs1=rd_full, shamt=shamt)
    if f3 == 0b010:
        imm = (((h >> 2) & 0x3) << 6) | (((h >> 12) & 1) << 5) | \
              (((h >> 4) & 0x7) << 2)
        return mk("LW", rd=rd_full, rs1=2, offset=imm)
    if f3 == 0b100:
        b12 = (h >> 12) & 1
        if b12 == 0:
            if rs2_full != 0:
                return mk("ADD", rd=rd_full, rs1=0, rs2=rs2_full)
            return mk("JALR", rd=0, rs1=rd_full, offset=0)
        if rs2_full != 0:
            return mk("ADD", rd=rd_full, rs1=rd_full, rs2=rs2_full)
        if rd_full != 0:
            return mk("JALR", rd=1, rs1=rd_full, offset=0)
        return mk("EBREAK")
    if f3 == 0b110:
        imm = (((h >> 7) & 0x3) << 6) | (((h >> 9) & 0xF) << 2)
        return mk("SW", rs1=2, rs2=rs2_full, offset=imm)
    return mk("UNIMP")


def decode_stream(code: bytes, valid_size: int):
    """Iterate DecodedInstructions over a little-endian code buffer
    (inst_decoder.rs:67-113)."""
    pos = 0
    remaining = valid_size
    out = []
    while remaining > 0 and pos < len(code):
        h = int.from_bytes(code[pos:pos + 2], "little")
        if (h & 0b11) != 0b11:
            out.append(decode_compressed(h))
            pos += 2
            remaining -= 2
        else:
            if pos + 4 > len(code):
                break
            w = int.from_bytes(code[pos:pos + 4], "little")
            out.append(decode_word(w))
            pos += 4
            remaining -= 4
    return out
