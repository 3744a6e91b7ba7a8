"""Carry a machine's hidden ground truth across from plain data.

In this system the "parameters" are not weights but the hidden tables a
simulated machine is built from: a :class:`~repro_torch.core.uarch.UArch`
(ports, issue width, per-instruction μop behaviors) and the
:class:`~repro_torch.core.isa.ISA` it executes.  :func:`uarch_from_plain`
and :func:`isa_from_plain` rebuild them from plain data — the builtins
(and numpy scalars or arrays) that ``dataclasses.asdict`` gives for a uarch
and for each instruction spec, from this package or from any other with
the same field names — so any machine, including the reference package's,
can be handed to the port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.isa import ISA, InstrSpec, Operand
from repro_torch.core.uarch import InstrBehavior, UArch, Uop


def _strs(xs) -> tuple:
    return tuple(str(x) for x in xs)


def _scalars(cls, d: dict, skip=()) -> dict:
    """The scalar fields of dataclass ``cls`` present in ``d``, converted
    to the builtin type of their default (numpy ints and bools become
    ``int`` / ``bool``)."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or f.name not in d:
            continue
        v = d[f.name]
        if isinstance(f.default, bool):
            v = bool(v)
        elif isinstance(f.default, int):
            v = int(v)
        elif isinstance(f.default, str):
            v = str(v)
        out[f.name] = v
    return out


def _uop(d: dict) -> Uop:
    return Uop(frozenset(_strs(d["ports"])), _strs(d["reads"]),
               _strs(d["writes"]), int(d["latency"]), int(d["occupancy"]))


def _behavior(d) -> InstrBehavior | None:
    if d is None:
        return None
    return InstrBehavior(
        tuple(_uop(u) for u in d["uops"]),
        same_reg=_behavior(d.get("same_reg")),
        **_scalars(InstrBehavior, d, skip=("uops", "same_reg")))


def uarch_from_plain(d: dict) -> UArch:
    """A :class:`UArch` from ``dataclasses.asdict`` of a uarch."""
    return UArch(str(d["name"]), _strs(d["ports"]), int(d["issue_width"]),
                 {str(k): _behavior(v) for k, v in d["behaviors"].items()},
                 **_scalars(UArch, d, skip=("name", "ports", "issue_width",
                                            "behaviors")))


def isa_from_plain(specs) -> ISA:
    """An :class:`ISA` from ``dataclasses.asdict`` of each instruction spec
    (in ISA iteration order)."""
    return ISA(InstrSpec(
        str(s["name"]), str(s["mnemonic"]),
        tuple(Operand(str(o["name"]), str(o["otype"]), bool(o["read"]),
                      bool(o["written"]), bool(o["implicit"]),
                      int(o["width"])) for o in s["operands"]),
        **_scalars(InstrSpec, s, skip=("name", "mnemonic", "operands")))
        for s in specs)

