"""Machine-readable ISA description (the paper's XED→XML analogue, §6.1).

The paper extracts a machine-readable description of the x86 instruction set
from Intel XED's configuration files because the microbenchmark *generators*
(§5.2) need to know, for every instruction: the explicit and implicit
operands, their types and widths, which are read / written / both, and
special semantics (zero idioms, move elimination candidates, divider usage,
serializing/system instructions, control flow).

Here the same information lives in :class:`InstrSpec` records. The registry
is the single source of truth used by

  * the microbenchmark generators (blocking/latency/throughput),
  * the simulated machine's ground-truth tables (core/uarch.py),
  * the XML/JSON export (core/model_io.py).

Register classes model the structure that drives the paper's case analysis
in §5.2: gpr / vec / flags / mem, plus operand widths (partial-register
handling) and read-modify-write flags (the "both read and written" case).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable


# operand types
GPR = "gpr"
VEC = "vec"
FLAGS = "flags"
MEM = "mem"
IMM = "imm"


@dataclass(frozen=True)
class Operand:
    name: str          # "op1", "op2", "flags", "mem", ...
    otype: str         # gpr | vec | flags | mem | imm
    read: bool
    written: bool
    implicit: bool = False
    width: int = 64

    @property
    def rmw(self) -> bool:
        return self.read and self.written


def op(name, otype, mode, implicit=False, width=64) -> Operand:
    """mode: 'r' | 'w' | 'rw'."""
    return Operand(name, otype, "r" in mode, "w" in mode, implicit, width)


@dataclass(frozen=True)
class InstrSpec:
    name: str                      # unique variant name, e.g. "ADD_R64_R64"
    mnemonic: str
    operands: tuple[Operand, ...]
    uses_divider: bool = False
    serializing: bool = False
    system: bool = False
    control_flow: bool = False
    may_eliminate: bool = False    # reg-reg move elimination candidate
    zero_idiom: bool = False       # same-reg => breaks dependency
    is_nop: bool = False
    extension: str = "BASE"        # BASE | SSE | AVX  (§5.1.1 transition penalties)

    @property
    def sources(self) -> tuple[Operand, ...]:
        return tuple(o for o in self.operands if o.read)

    @property
    def dests(self) -> tuple[Operand, ...]:
        return tuple(o for o in self.operands if o.written)

    @property
    def explicit_operands(self) -> tuple[Operand, ...]:
        return tuple(o for o in self.operands if not o.implicit)

    def reads_flags(self) -> bool:
        return any(o.otype == FLAGS and o.read for o in self.operands)

    def writes_flags(self) -> bool:
        return any(o.otype == FLAGS and o.written for o in self.operands)

    def replace(self, **kw) -> "InstrSpec":
        return replace(self, **kw)


class ISA:
    """A registry of instruction variants (one x86-like μISA instance)."""

    def __init__(self, specs: Iterable[InstrSpec] = ()):  # noqa: D107
        self._specs: dict[str, InstrSpec] = {}
        for s in specs:
            self.add(s)

    def add(self, spec: InstrSpec) -> None:
        if spec.name in self._specs:
            raise ValueError(f"duplicate instruction {spec.name}")
        self._specs[spec.name] = spec

    def __getitem__(self, name: str) -> InstrSpec:
        return self._specs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __iter__(self):
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    def names(self) -> list[str]:
        return list(self._specs)


# ---------------------------------------------------------------------------
# the test μISA — an x86-flavored instruction set exercising every structural
# case from §5.2: implicit flags, RMW operands, type-crossing moves, loads,
# stores, dividers, zero idioms, eliminable movs, chain instructions.
# ---------------------------------------------------------------------------

_F = op("flags", FLAGS, "w", implicit=True)
_Frw = op("flags", FLAGS, "rw", implicit=True)
_Fr = op("flags", FLAGS, "r", implicit=True)


def _alu2(name, *, flags="w", zero_idiom=False, ext="BASE"):
    """Two-operand ALU: op1 rw, op2 r, writes (or rw) flags."""
    ops = [op("op1", GPR, "rw"), op("op2", GPR, "r")]
    if flags == "w":
        ops.append(_F)
    elif flags == "rw":
        ops.append(_Frw)
    return InstrSpec(name=f"{name}_R64_R64", mnemonic=name,
                     operands=tuple(ops), zero_idiom=zero_idiom, extension=ext)


def build_test_isa() -> ISA:
    isa = ISA()
    # --- integer ALU ---
    for nm in ("ADD", "SUB", "AND", "OR"):
        isa.add(_alu2(nm))
    isa.add(_alu2("XOR", zero_idiom=True))
    isa.add(_alu2("SUBZ", zero_idiom=True))  # second zero idiom (SUB-like)
    isa.add(_alu2("ADC", flags="rw"))        # reads+writes flags (carry)
    isa.add(_alu2("SBB", flags="rw"))
    isa.add(InstrSpec("CMP_R64_R64", "CMP",
                      (op("op1", GPR, "r"), op("op2", GPR, "r"), _F)))
    isa.add(InstrSpec("TEST_R64_R64", "TEST",
                      (op("op1", GPR, "r"), op("op2", GPR, "r"), _F)))
    isa.add(InstrSpec("INC_R64", "INC", (op("op1", GPR, "rw"), _F)))
    isa.add(InstrSpec("NOT_R64", "NOT", (op("op1", GPR, "rw"),)))
    isa.add(InstrSpec("LEA_R64", "LEA",
                      (op("op1", GPR, "w"), op("op2", GPR, "r"))))
    isa.add(InstrSpec("POPCNT_R64_R64", "POPCNT",
                      (op("op1", GPR, "w"), op("op2", GPR, "r"), _F)))
    isa.add(InstrSpec("BSWAP_R32", "BSWAP", (op("op1", GPR, "rw", width=32),)))
    isa.add(InstrSpec("BSWAP_R64", "BSWAP", (op("op1", GPR, "rw"),)))
    # --- moves ---
    isa.add(InstrSpec("MOV_R64_R64", "MOV",
                      (op("op1", GPR, "w"), op("op2", GPR, "r")),
                      may_eliminate=True))
    isa.add(InstrSpec("MOVSX_R64_R32", "MOVSX",
                      (op("op1", GPR, "w"), op("op2", GPR, "r", width=32))))
    isa.add(InstrSpec("MOVSX_R64_R8", "MOVSX",
                      (op("op1", GPR, "w"), op("op2", GPR, "r", width=8))))
    isa.add(InstrSpec("MOVZX_R64_R16", "MOVZX",
                      (op("op1", GPR, "w"), op("op2", GPR, "r", width=16)),
                      may_eliminate=True))
    # --- shifts / rotates (implicit flags RMW; SHLD same-reg special) ---
    for nm in ("SHL", "SHR", "SAR", "ROL", "ROR"):
        isa.add(InstrSpec(f"{nm}_R64_I8", nm,
                          (op("op1", GPR, "rw"), op("imm", IMM, "r"), _Frw)))
    isa.add(InstrSpec("SHLD_R64_R64_I8", "SHLD",
                      (op("op1", GPR, "rw"), op("op2", GPR, "r"),
                       op("imm", IMM, "r"), _F)))
    # --- multiply / divide ---
    isa.add(InstrSpec("IMUL_R64_R64", "IMUL",
                      (op("op1", GPR, "rw"), op("op2", GPR, "r"), _F)))
    isa.add(InstrSpec("MUL_R64", "MUL",
                      (op("op1", GPR, "rw"), op("op2", GPR, "r"),
                       op("hi", GPR, "w", implicit=True), _F)))
    isa.add(InstrSpec("DIV_R64", "DIV",
                      (op("op1", GPR, "rw"), op("op2", GPR, "r"),
                       op("hi", GPR, "rw", implicit=True), _F),
                      uses_divider=True))
    # --- condition-flag consumers ---
    isa.add(InstrSpec("SETC_R8", "SETC",
                      (op("op1", GPR, "w", width=8), _Fr)))
    isa.add(InstrSpec("CMOVBE_R64_R64", "CMOVBE",
                      (op("op1", GPR, "rw"), op("op2", GPR, "r"), _Fr)))
    isa.add(InstrSpec("CMC", "CMC", (_Frw,)))
    isa.add(InstrSpec("SAHF", "SAHF",
                      (op("op1", GPR, "r", width=8), _F)))
    # --- memory ---
    isa.add(InstrSpec("MOV_R64_M64", "MOV",
                      (op("op1", GPR, "w"), op("mem", MEM, "r"))))
    isa.add(InstrSpec("MOV_M64_R64", "MOV",
                      (op("mem", MEM, "w"), op("op1", GPR, "r"))))
    isa.add(InstrSpec("ADD_R64_M64", "ADD",
                      (op("op1", GPR, "rw"), op("mem", MEM, "r"), _F)))
    isa.add(InstrSpec("IMUL_R64_M64", "IMUL",
                      (op("op1", GPR, "rw"), op("mem", MEM, "r"), _F)))
    # --- vector (SSE-like and AVX-like for the two blocking sets) ---
    for ext, pre in (("SSE", "P"), ("AVX", "VP")):
        isa.add(InstrSpec(f"{pre}ADDD_X_X", f"{pre}ADDD",
                          (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                          extension=ext))
        isa.add(InstrSpec(f"{pre}MULD_X_X", f"{pre}MULD",
                          (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                          extension=ext))
        isa.add(InstrSpec(f"{pre}SHUFB_X_X", f"{pre}SHUFB",
                          (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                          extension=ext))
        isa.add(InstrSpec(f"{pre}AND_X_X", f"{pre}AND",
                          (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                          extension=ext))
        isa.add(InstrSpec(f"{pre}CMPGTQ_X_X", f"{pre}CMPGTQ",
                          (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                          zero_idiom=True, extension=ext))
    isa.add(InstrSpec("SHUFPS_X_X", "SHUFPS",
                      (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                      extension="SSE"))
    # non-destructive shuffles: the §5.2.1 SIMD chain instructions
    isa.add(InstrSpec("PSHUFD_X_X", "PSHUFD",
                      (op("op1", VEC, "w"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MOVSHDUP_X_X", "MOVSHDUP",
                      (op("op1", VEC, "w"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("ADDPS_X_X", "ADDPS",
                      (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MULPS_X_X", "MULPS",
                      (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("DIVPS_X_X", "DIVPS",
                      (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                      uses_divider=True, extension="SSE"))
    isa.add(InstrSpec("AESDEC_X_X", "AESDEC",
                      (op("op1", VEC, "rw"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("AESDEC_X_M", "AESDEC",
                      (op("op1", VEC, "rw"), op("mem", MEM, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MOVQ2DQ_X_X", "MOVQ2DQ",
                      (op("op1", VEC, "w"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MOVAPS_X_X", "MOVAPS",
                      (op("op1", VEC, "w"), op("op2", VEC, "r")),
                      may_eliminate=True, extension="SSE"))
    # --- type-crossing (vec <-> gpr): chain-instruction candidates §5.2.1 ---
    isa.add(InstrSpec("MOVD_R64_X", "MOVD",
                      (op("op1", GPR, "w"), op("op2", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MOVD_X_R64", "MOVD",
                      (op("op1", VEC, "w"), op("op2", GPR, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("PEXTRQ_R64_X", "PEXTRQ",
                      (op("op1", GPR, "w"), op("op2", VEC, "r")),
                      extension="SSE"))
    # --- stores with data computation / vector store ---
    isa.add(InstrSpec("MOVAPS_M_X", "MOVAPS",
                      (op("mem", MEM, "w"), op("op1", VEC, "r")),
                      extension="SSE"))
    isa.add(InstrSpec("MOVAPS_X_M", "MOVAPS",
                      (op("op1", VEC, "w"), op("mem", MEM, "r")),
                      extension="SSE"))
    # --- excluded-by-the-algorithm classes (must exist to be excluded) ---
    isa.add(InstrSpec("NOP", "NOP", (), is_nop=True))
    isa.add(InstrSpec("PAUSE", "PAUSE", ()))
    isa.add(InstrSpec("LFENCE", "LFENCE", (), serializing=True))
    isa.add(InstrSpec("CPUID", "CPUID",
                      (op("op1", GPR, "rw", implicit=True),),
                      serializing=True, system=True))
    isa.add(InstrSpec("RDMSR", "RDMSR",
                      (op("op1", GPR, "w", implicit=True),), system=True))
    isa.add(InstrSpec("JMP_R64", "JMP", (op("op1", GPR, "r"),),
                      control_flow=True))
    return isa


TEST_ISA = build_test_isa()
