"""Finding blocking instructions (§5.1.1).

A *blocking instruction* for a port combination P is an instruction whose
μops can use all ports in P but no other port sharing those functional
units. The algorithm:

1. take all 1-μop instructions, excluding system / serializing /
   zero-latency / PAUSE / register-dependent control flow (§5.1.1),
2. group them by the set of ports they use when run in isolation,
3. pick from each group the instruction with the highest throughput
   (lowest cycles/instr) — this naturally avoids candidates whose implicit
   read-modify-write operands (flags!) serialize their own instances,
4. the store-data / store-address combinations get the 2-μop register→memory
   MOV special case,
5. SSE and AVX get separate blocking sets to avoid transition penalties.

The algorithm is expressed as a :mod:`repro_torch.core.plan` measurement plan
(:func:`blocking_plan`) with two waves: one isolation wave over all
candidates (μop count and port distribution come from the same experiment;
the store MOV's isolation run rides along), then one throughput wave over
the 1-μop survivors. :func:`find_blocking_instructions` remains the
run-to-completion wrapper over the plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.engine import as_engine
from repro_torch.core.isa import ISA, MEM, InstrSpec
from repro_torch.core.machine import (independent_experiment, ports_from_counters,
                                      uops_from_counters)
from repro_torch.core.plan import MeasurementPlan, run_plan


@dataclass
class BlockingSet:
    """port combination -> (instr name, uops the instr puts on that combo)."""
    instrs: dict = field(default_factory=dict)     # frozenset -> str
    uops_on_pc: dict = field(default_factory=dict)  # frozenset -> int

    def combos(self) -> list[frozenset]:
        return list(self.instrs)


def _excluded(spec: InstrSpec) -> bool:
    return (spec.system or spec.serializing or spec.control_flow
            or spec.is_nop or spec.mnemonic == "PAUSE" or spec.uses_divider)


def measured_throughput(machine, spec: InstrSpec, n: int = 8) -> float:
    engine = as_engine(machine)
    return engine.measure(independent_experiment(spec, n)).cycles / n


def _blocking_gen(isa: ISA, extensions: tuple[str, ...]):
    cands = [spec for spec in isa
             if not _excluded(spec) and spec.extension in extensions
             and not any(o.otype == MEM and o.written for o in spec.operands)]
    # store combos handled below (2-μop MOV special case); its isolation
    # experiment joins wave 1 so the special case costs no extra wave
    store = next((s for s in isa
                  if any(o.otype == MEM and o.written for o in s.operands)
                  and s.mnemonic == "MOV"), None)

    # wave 1: isolation runs — μop count and port distribution per candidate
    wave = [independent_experiment(s, 12) for s in cands]
    if store is not None:
        wave.append(independent_experiment(store, 12))
    iso = yield wave
    store_iso = iso[len(cands)] if store is not None else None
    one_uop = [(s, frozenset(ports_from_counters(c, 12)))
               for s, c in zip(cands, iso)
               if abs(uops_from_counters(c, 12) - 1.0) <= 0.1]
    # zero-latency / eliminated candidates have no ports — drop them before
    # spending throughput measurements on them
    one_uop = [(s, ports) for s, ports in one_uop if ports]

    # wave 2: throughput of the 1-μop survivors
    tputs = yield [independent_experiment(s, 8) for s, _ in one_uop]
    groups: dict[frozenset, list[tuple[float, str]]] = {}
    for (spec, ports), c_tp in zip(one_uop, tputs):
        groups.setdefault(ports, []).append((c_tp.cycles / 8, spec.name))

    bs = BlockingSet()
    for pc, cand in groups.items():
        cand.sort()
        bs.instrs[pc] = cand[0][1]
        bs.uops_on_pc[pc] = 1

    # store data / store address ports: use the reg->mem MOV (2 μops; one on
    # the store-data combo, one on the store-address combo).
    if store is not None and abs(uops_from_counters(store_iso, 12) - 2.0) < 0.1:
        dist = ports_from_counters(store_iso, 12)
        # the store-data μop pins one port (~1 μop/instance); the
        # store-address μop spreads over its AGU ports (fractional counts)
        data_pc = frozenset(p for p in dist if dist[p] > 0.9)
        addr_pc = frozenset(p for p in dist if 0.05 < dist[p] <= 0.9)
        for pc in (data_pc, addr_pc):
            if pc and pc not in bs.instrs:
                bs.instrs[pc] = store.name
                bs.uops_on_pc[pc] = 1
    return bs


def blocking_plan(isa: ISA, extensions: tuple[str, ...] = ("BASE", "SSE")):
    """Plan producing the :class:`BlockingSet` for ``extensions``."""
    return MeasurementPlan(_blocking_gen(isa, extensions),
                           name=f"blocking[{'/'.join(extensions)}]",
                           phase="blocking")


def find_blocking_instructions(machine, isa: ISA,
                               extensions: tuple[str, ...] = ("BASE", "SSE"),
                               ) -> BlockingSet:
    """Discover one blocking instruction per observed port combination.

    ``extensions`` restricts candidates (separate SSE vs AVX sets, §5.1.1).
    Run-to-completion wrapper over :func:`blocking_plan`."""
    return run_plan(machine, blocking_plan(isa, extensions))
