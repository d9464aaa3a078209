"""PowerPC 450 "Double Hummer" instruction-set model: the subset the plan
cost model and the in-order simulator use.

The PPC450 core issues at most one floating-point instruction per cycle
(FPU), one load/store every two cycles (LSU), and integer ops in parallel
(IU).  FPRs are 16-byte (primary, secondary) pairs.  Latencies (paper
sect. 3.2/3.3): FPU result -> FPR 5 cycles; L1 load -> FPR 4 cycles (L2 ~15,
L3 ~56); GPR writes 1 cycle; LSU instructions occupy the load/store pipe for
2 cycles.

This is the port's own copy of ``repro.core.isa`` (which the port does not
import): the plan compiler ranks its candidate schedules on this machine
model, so the copy must stay value-for-value identical.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

FPU_LATENCY = 5          # cycles until an FPU result may be consumed
L1_LOAD_LATENCY = 4      # cycles until a load from L1 may be consumed
L2_LOAD_LATENCY = 15
L3_LOAD_LATENCY = 56     # 50 memory + 6 instruction (paper sect. 3.2)
GPR_LATENCY = 1
LSU_ISSUE_CYCLES = 2     # one LSU op every other cycle
FPU_ISSUE_CYCLES = 1
IU_ISSUE_CYCLES = 1

NUM_FPRS = 32


class Unit(enum.Enum):
    FPU = "FPU"
    LSU = "LSU"
    IU = "IU"


@dataclasses.dataclass(frozen=True)
class MemRef:
    """Symbolic memory operand: address = GPR[base] + offset (bytes)."""

    base: str           # symbolic GPR name holding the base address
    offset: int         # immediate byte offset
    size: int           # 8 (half FPR) or 16 (quad)
    is_store: bool
    space: str = "A"    # alias group ("A" input, "R" output, "W" weights)


@dataclasses.dataclass(frozen=True)
class Instr:
    """One PPC450 instruction with symbolic register operands."""

    mnemonic: str
    unit: Unit
    dest: Optional[str]                 # symbolic register written
    srcs: Tuple[str, ...]               # symbolic registers read
    mem: Optional[MemRef] = None
    imm: int = 0
    comment: str = ""

    @property
    def latency(self) -> int:
        if self.unit is Unit.FPU:
            return FPU_LATENCY
        if self.unit is Unit.LSU:
            return 0 if (self.mem and self.mem.is_store) else L1_LOAD_LATENCY
        return GPR_LATENCY

    @property
    def issue_cycles(self) -> int:
        if self.unit is Unit.LSU:
            return LSU_ISSUE_CYCLES
        return 1


def _fpu(mn: str, dest: str, srcs: Sequence[str], comment: str = "") -> Instr:
    return Instr(mn, Unit.FPU, dest, tuple(srcs), comment=comment)


def fxcpmul(t: str, w: str, c: str, comment: str = "") -> Instr:
    """T.p = W.p*C.p ; T.s = W.p*C.s  (parallel, weight primary)."""
    return _fpu("fxcpmul", t, (w, c), comment)


def fpmadd(t: str, a: str, c: str, b: str, comment: str = "") -> Instr:
    """T = A*C + B (both halves, plain parallel FMA)."""
    return _fpu("fpmadd", t, (a, c, b), comment)


def fpadd(t: str, a: str, b: str, comment: str = "") -> Instr:
    return _fpu("fpadd", t, (a, b), comment)


def lfpdx(t: str, base: str, offset: int, space: str = "A",
          comment: str = "") -> Instr:
    """Quad (16B, aligned) load: T.p = mem[ea], T.s = mem[ea+8]."""
    return Instr("lfpdx", Unit.LSU, t, (base,),
                 mem=MemRef(base, offset, 16, False, space), comment=comment)


def stfpdx(s: str, base: str, offset: int, space: str = "R",
           comment: str = "") -> Instr:
    """Quad (16B, aligned) store."""
    return Instr("stfpdx", Unit.LSU, None, (s, base),
                 mem=MemRef(base, offset, 16, True, space), comment=comment)


# Semantics of the fxc* multiply(-add) family: fn(w, c, t) -> (p, s) over
# (primary, secondary) float pairs.
FPU_SEMANTICS: dict[str, Callable] = {
    "fxcpmul":  lambda w, c, t: (w[0] * c[0], w[0] * c[1]),
    "fxcsmul":  lambda w, c, t: (w[1] * c[0], w[1] * c[1]),
    "fxcpxmul": lambda w, c, t: (w[0] * c[1], w[0] * c[0]),
    "fxcsxmul": lambda w, c, t: (w[1] * c[1], w[1] * c[0]),
    "fxcpmadd": lambda w, c, t: (t[0] + w[0] * c[0], t[1] + w[0] * c[1]),
    "fxcsmadd": lambda w, c, t: (t[0] + w[1] * c[0], t[1] + w[1] * c[1]),
    "fxcpxmadd": lambda w, c, t: (t[0] + w[0] * c[1], t[1] + w[0] * c[0]),
    "fxcsxmadd": lambda w, c, t: (t[0] + w[1] * c[1], t[1] + w[1] * c[0]),
}
