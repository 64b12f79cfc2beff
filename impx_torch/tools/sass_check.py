"""A check of the built kernels' machine code (SASS) for wgmma register faults.

A wgmma (HGMMA in SASS) reads its A operand from registers and writes its
accumulator after it issues, until the WARPGROUP.DEPBAR that waits for it.
The check reads every function of a library that issues HGMMA and reports
two faults of register allocation:
  * inside a loop, an instruction that writes a register that an HGMMA of
    the loop reads as its A operand where the loop has not written that
    register before the HGMMA: a fragment loaded before the loop (the fp32
    forward's Q hi and lo) that the next iteration reads overwritten;
  * an instruction that writes an in-flight HGMMA's A or accumulator
    registers before the wait.
Such a fault leaves PTX that is right and a kernel that is wrong from its
second key tile on: ptxas built tools/tf32_phases.py's fp32 forward with one
TF32 pass so (PERF.md section 6). chip_smoke.py runs the check on every
library it builds, tf32_phases.py on every variant. Needs cuobjdump (the CUDA
toolkit beside nvcc), not a card.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path

from impx_torch.ops.kernels import _build

_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"-?\|?R(\d+)(?:\.reuse)?\|?(?:\.[A-Z0-9_]+)*")
# opcodes whose first operand is not a general register they write
_NO_DEST = ("ST", "BRA", "BAR", "HGMMA", "WARPGROUP", "EXIT", "RET", "DEPBAR", "LDGDEPBAR", "NOP", "MEMBAR",
            "FENCE", "RED", "ATOM", "SYNCS", "CALL", "BSYNC", "BSSY", "WARPSYNC", "ISETP", "FSETP", "DSETP",
            "PLOP3", "U", "R2UR", "S2UR", "VOTEU", "ELECT")


def instructions(sass: str) -> list[tuple[int, str]]:
    """(address, instruction) of each SASS line, the guard predicate kept."""
    return [(int(m.group(1), 16), m.group(2)) for m in map(_INSTR.match, sass.splitlines()) if m]


def _reg(token: str) -> int | None:
    m = _REG.fullmatch(token.strip())
    return int(m.group(1)) if m else None


def _body(instr: str) -> str:
    return re.sub(r"^@!?U?P[T0-9]\s+", "", instr)


def written(instr: str) -> list[int]:
    """The general registers an instruction writes (its first operand and the
    pairs or quads of a wide result)."""
    op, _, rest = _body(instr).partition(" ")
    if op.startswith(_NO_DEST):
        return []
    first = _reg(rest.split(",")[0])
    if first is None:
        return []
    width = 4 if ".128" in op else 2 if (".64" in op or "WIDE" in op or op == "CS2R") else 1
    return list(range(first, first + width))


def hgmma(instr: str) -> tuple[list[int], list[int]] | None:
    """(accumulator registers, A registers) of an HGMMA (A empty when A is
    read from shared memory), else None."""
    op, _, rest = _body(instr).partition(" ")
    if not op.startswith("HGMMA"):
        return None
    parts = rest.split(",")
    n = int(re.search(r"64x(\d+)x", op).group(1))
    d, a = _reg(parts[0]), _reg(parts[1])
    return list(range(d, d + n // 2)), ([] if a is None else list(range(a, a + 4)))


def faults(instrs: list[tuple[int, str]]) -> list[str]:
    """Every fault of one function's instructions, as text."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    out = []
    for i, (addr, instr) in enumerate(instrs):   # each backward branch closes a loop
        m = re.search(r"BRA (?:`\(.*?\) )?0x([0-9a-f]+)", instr)
        if not m or int(m.group(1), 16) >= addr or int(m.group(1), 16) not in index:
            continue
        body = instrs[index[int(m.group(1), 16)]:i + 1]
        seen, outside = set(), {}
        for a, ins in body:
            mma = hgmma(ins)
            for r in mma[1] if mma else []:
                if r not in seen:
                    outside.setdefault(r, a)
            seen.update(written(ins))
        for a, ins in body:
            out += [f"{a:#x} {ins}: writes R{r}, the A operand of the HGMMA at {outside[r]:#x} in the loop "
                    f"{body[0][0]:#x}-{addr:#x}" for r in written(ins) if r in outside]
    in_flight: dict[int, int] = {}
    for addr, instr in instrs:
        if "WARPGROUP.DEPBAR" in instr:
            in_flight = {}
            continue
        mma = hgmma(instr)
        if mma:
            in_flight.update({r: addr for r in mma[0] + mma[1]})
            continue
        out += [f"{addr:#x} {instr}: writes R{r} of the HGMMA at {in_flight[r]:#x} before its wait"
                for r in written(instr) if r in in_flight]
    return out


def library_faults(path: str | Path) -> dict[str, list[str]]:
    """{function: faults} for every function of a library that issues HGMMA."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    out = {}
    for block in re.split(r"(?=\n\s+Function : )", sass):
        name = re.search(r"Function : (\S+)", block)
        if name and "HGMMA" in block:
            out[name.group(1)] = faults(instructions(block))
    return out

