"""Instruction counts of a built kernel's SASS, and the card's issue rates.

The operations bound of an integer kernel is its instruction count over
the rate at which the card issues those instructions.  The counts come
from ``cuobjdump -sass`` of the library ``kernel_build`` made; the rates
are the Hopper white paper's, which the roofline microbenchmark
(``p1_tpu_torch/benchmarks/vpu_roofline.py``) measures on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import re
import shutil
import subprocess

#: Hopper: 4 sub-partitions per SM, each issuing one warp instruction per
#: clock (128 thread-instructions) of which 16 lanes are integer ALU (64 per
#: SM per clock: IADD3, LOP3, SHF, ISETP, ...) — NVIDIA H100 white paper.
DISPATCH_PER_SM_CLK = 128
ALU_PER_SM_CLK = 64
#: Integer multiply-adds (IMAD, IMAD.WIDE, ...) issue to the FMA pipe: 64
#: per clock per SM on compute capability 9.0 (CUDA C++ Programming
#: Guide, arithmetic instruction throughput).  IMAD.WIDE is counted as one
#: issue like the rest, which can only make a bound lower.
FMA_PER_SM_CLK = 64
#: SASS opcodes that do not occupy the integer ALU pipe.  IMAD and VIADD
#: are integer adds that the compiler issues to the FMA pipe: on the H100
#: the roofline's ``rot`` and ``sha`` mixes (SHF and LOP3 only) saturate at
#: 63.9 ALU instructions per clock per SM, while its ``round`` mix would
#: reach 72 if its VIADDs counted, above the pipe's 64 lanes (PERF.md).
_NOT_ALU = re.compile(
    r"^(NOP|IMAD|VIADD|IMUL|FFMA|FADD|FMUL|BRA|EXIT|BSSY|BSYNC|RET|CALL|WARPSYNC|BAR|"
    r"S2R|S2UR|CS2R|LD|ST|ATOM|RED|U[A-Z0-9]+)"
)
_INSN = re.compile(
    r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);"
)


def is_alu(opcode: str) -> bool:
    return not _NOT_ALU.match(opcode)


def is_fma(opcode: str) -> bool:
    """Integer work that issues to the FMA pipe (IMAD in all its forms,
    VIADD, IMUL)."""
    return opcode.startswith(("IMAD", "VIADD", "IMUL"))


@dataclasses.dataclass(frozen=True)
class Insn:
    address: int
    opcode: str  # with its modifiers, e.g. "SHF.R.W.U32.HI"
    operands: str


def disassemble(lib_path: pathlib.Path) -> str:
    """``cuobjdump -sass`` of a library; also written beside it (``.sass``)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout  # fmt: skip
    lib_path.with_suffix(".sass").write_text(sass)
    return sass


def function_insns(sass: str, kernel: str) -> list[Insn]:
    """The instructions (NOPs excluded) of the one function whose mangled
    name contains ``kernel``."""
    found: dict[str, list[Insn]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = found.setdefault(name, []) if kernel in name else None
            continue
        m = _INSN.match(line)
        if current is not None and m and not m.group(2).startswith("NOP"):
            current.append(Insn(int(m.group(1), 16), m.group(2), m.group(3).strip()))
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} SASS functions match {kernel!r}: {sorted(found)}")
    insns = next(iter(found.values()))
    if not insns:
        raise RuntimeError(f"no SASS found for {kernel}")
    return insns


def counts(insns: list[Insn]) -> tuple[int, int]:
    """(all instructions, integer-ALU instructions)."""
    return len(insns), sum(is_alu(i.opcode) for i in insns)


def sass_counts(lib_path: pathlib.Path, kernel: str) -> tuple[int, int]:
    """(all instructions, integer-ALU instructions) of ``kernel``'s SASS,
    NOPs excluded.  For a kernel fully unrolled over one work item (one
    nonce, one header) the static count is one item's work plus a few tens
    of setup instructions."""
    return counts(function_insns(disassemble(lib_path), kernel))


def loop_ranges(insns: list[Insn]) -> list[tuple[int, int]]:
    """(first, last) address of each loop of the function, by first
    address: from the target of a backward branch through that branch.
    (The ``BRA`` to itself that ends every function after its ``EXIT`` is
    no loop.)"""
    loops = []
    for insn in insns:
        m = re.match(r"(?:`\()?(0x[0-9a-f]+)", insn.operands)
        if insn.opcode.startswith("BRA") and m and int(m.group(1), 16) < insn.address:
            loops.append((int(m.group(1), 16), insn.address))
    return sorted(loops)


def loop_bodies(insns: list[Insn]) -> list[list[Insn]]:
    """The instructions of each loop of the function (``loop_ranges``)."""
    return [[i for i in insns if start <= i.address <= end] for start, end in loop_ranges(insns)]


def loop_body(insns: list[Insn]) -> list[Insn]:
    """The instructions of the function's one loop."""
    bodies = loop_bodies(insns)
    if len(bodies) != 1:
        raise RuntimeError(f"expected one backward branch, found {len(bodies)}")
    return bodies[0]


def per_item_counts(insns: list[Insn], trips: int) -> tuple[int, int]:
    """(all, integer-ALU) instructions one thread executes in a function
    whose loops (none nested) each run ``trips`` times, e.g. a compression
    with rounds 16..63 in three passes of 16."""
    total, alu = counts(insns)
    for body in loop_bodies(insns):
        more = counts(body)
        total, alu = total + (trips - 1) * more[0], alu + (trips - 1) * more[1]
    return total, alu


def opcode_histogram(insns: list[Insn]) -> dict[str, int]:
    """Instructions by base opcode (``SHF.R.W.U32.HI`` counts as ``SHF``)."""
    return dict(collections.Counter(i.opcode.split(".")[0] for i in insns).most_common())


def nested_counts(insns: list[Insn], trips: list[int]) -> tuple[int, int, int]:
    """(all, integer-ALU, FMA-pipe) instructions one thread executes in a
    function whose loops, in ``loop_ranges`` order, run ``trips[k]`` times
    each time they are entered; an instruction counts once per trip of
    every loop around it (nested loops multiply)."""
    ranges = loop_ranges(insns)
    if len(ranges) != len(trips):
        raise RuntimeError(f"expected {len(trips)} loops, found {len(ranges)}: {ranges}")
    total = alu = fma = 0
    for i in insns:
        weight = 1
        for (start, end), n in zip(ranges, trips):
            if start <= i.address <= end:
                weight *= n
        total += weight
        alu += weight * is_alu(i.opcode)
        fma += weight * is_fma(i.opcode)
    return total, alu, fma
