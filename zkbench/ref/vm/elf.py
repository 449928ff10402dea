"""Minimal ELF32 RISC-V loader, mirroring the reference's segment handling
(latticeum/crates/vm/src/riscvm/elf.rs:34-192): loads PT_LOAD segments
word-by-word into an address->word image, captures the executable segment as
raw_code, zero-fills .bss, validates class/machine/entry alignment."""

from __future__ import annotations

import struct
from dataclasses import dataclass

WORD_SIZE = 4
PT_LOAD = 1
PF_X = 1
EM_RISCV = 243


class ElfLoadingError(Exception):
    pass


@dataclass
class Code:
    start: int
    size: int
    bytes: bytes


@dataclass
class Elf:
    image: dict          # address -> u32 word
    entry_point: int
    raw_code: Code


def load_elf_bytes(data: bytes, max_mem: int = 1 << 32) -> Elf:
    if len(data) < 52 or data[:4] != b"\x7fELF":
        raise ElfLoadingError("not an ELF file")
    ei_class, ei_data = data[4], data[5]
    if ei_class != 1:
        raise ElfLoadingError("elf file has wrong class, expected 32bit")
    if ei_data != 1:
        raise ElfLoadingError("expected little-endian ELF")
    (e_type, e_machine, e_version, e_entry, e_phoff, e_shoff, e_flags,
     e_ehsize, e_phentsize, e_phnum) = struct.unpack_from("<HHIIIIIHHH", data, 16)
    if e_machine != EM_RISCV:
        raise ElfLoadingError("elf file has wrong machine type, expected RISC-V")
    if e_entry % 2 != 0:
        raise ElfLoadingError("entry_point is not divisible by alignment")

    image: dict[int, int] = {}
    raw_code_start = 0
    raw_code_size = 0
    raw_code = bytearray()

    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, p_paddr, p_filesz, p_memsz, p_flags,
         p_align) = struct.unpack_from("<IIIIIIII", data, off)
        if p_type != PT_LOAD:
            continue
        if p_filesz > p_memsz:
            raise ElfLoadingError("segment has file_size > mem_size")
        if p_offset + p_filesz > len(data):
            raise ElfLoadingError("segment reads past end of file")
        is_text = (p_flags & PF_X) != 0
        if is_text:
            raw_code_start = p_vaddr
            raw_code_size = p_filesz
        seg = data[p_offset:p_offset + p_filesz]
        addr = p_vaddr
        pos = 0
        while pos + WORD_SIZE <= len(seg):
            word = int.from_bytes(seg[pos:pos + 4], "little")
            image[addr] = word
            if is_text:
                raw_code.extend(seg[pos:pos + 4])
            addr += WORD_SIZE
            pos += WORD_SIZE
        rem = seg[pos:]
        if rem:
            word_bytes = rem + b"\x00" * (WORD_SIZE - len(rem))
            image[addr] = int.from_bytes(word_bytes, "little")
            if is_text:
                raw_code.extend(word_bytes)
        # zero-fill (.bss)
        zstart = p_vaddr + p_filesz
        zend = p_vaddr + p_memsz
        if zstart != zend:
            a0 = (zstart + WORD_SIZE - 1) & ~(WORD_SIZE - 1)
            for a in range(a0, zend, WORD_SIZE):
                image.setdefault(a, 0)
                if is_text:
                    raw_code.extend(b"\x00\x00\x00\x00")

    if raw_code_start == 0 or raw_code_size == 0:
        raise ElfLoadingError("no executable segment found")

    return Elf(image=image, entry_point=e_entry,
               raw_code=Code(raw_code_start, raw_code_size, bytes(raw_code)))


def load_elf(path) -> Elf:
    with open(path, "rb") as f:
        return load_elf_bytes(f.read())
