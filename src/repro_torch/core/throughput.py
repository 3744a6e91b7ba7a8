"""Throughput (§4.2 definitions, §5.3 measurement + computation).

Two notions are produced for every instruction:

* ``measured`` (Fog/Granlund, Def. 2): cycles/instr over sequences of
  independent instances, for sequence lengths 1, 2, 4 and 8 (longer
  sequences can be *slower* — the paper's observation — so we keep the
  minimum and record the per-length values). For instructions with implicit
  read-modify-write operands an additional variant interleaves
  dependency-breaking instructions (which consume execution resources
  themselves, so it does not always help — both variants are recorded).

* ``computed`` (Intel, Def. 1): from the inferred port usage via the LP of
  §5.3.2 — the minimal achievable maximum port load. Not valid for divider
  instructions (the divider is not fully pipelined), which keep the measured
  value annotated instead.

All sequence lengths (and the divider high-operand variants) are independent
experiments, requested as one wave by a single-yield measurement plan
(:func:`throughput_plan`); under a :class:`~repro_torch.core.plan.WaveScheduler`
many instructions' throughput waves fuse into one. ``measure_throughput``
remains the run-to-completion wrapper.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.engine import Experiment, as_engine
from repro_torch.core.isa import FLAGS, ISA, InstrSpec
from repro_torch.core.lp import throughput_lp
from repro_torch.core.machine import (RegPool, flags_breaker, independent_experiment,
                                      independent_seq)
from repro_torch.core.plan import MeasurementPlan, run_plan
from repro_torch.core.port_usage import PortUsage

SEQ_LENS = (1, 2, 4, 8)


@dataclass
class ThroughputResult:
    instr: str
    measured: float = 0.0
    by_seq_len: dict = field(default_factory=dict)
    with_breakers: float | None = None
    computed_from_ports: float | None = None
    high_value: float | None = None  # divider worst-case operand class


def _throughput_gen(spec: InstrSpec, isa: ISA, value_hint: str):
    res = ThroughputResult(spec.name)

    wave = [independent_experiment(spec, n, value_hint) for n in SEQ_LENS]
    lens = list(SEQ_LENS)
    # implicit RMW operands: variant with dependency-breaking instructions
    rmw_flags = any(o.rmw and o.implicit and o.otype == FLAGS
                    for o in spec.operands)
    if rmw_flags:
        pool = RegPool()
        seq = []
        for ins in independent_seq(spec, pool, 4):
            seq.append(ins)
            seq.append(flags_breaker(isa, pool))
        wave.append(Experiment.of(seq))
    if spec.uses_divider:
        wave += [independent_experiment(spec, n, "high") for n in SEQ_LENS]

    counters = yield wave

    best = None
    for n, c in zip(lens, counters[:len(lens)]):
        cyc = c.cycles / n
        res.by_seq_len[n] = cyc
        best = cyc if best is None else min(best, cyc)
    res.measured = best
    rest = counters[len(lens):]
    if rmw_flags:
        # per-instr cycles of the *measured* instruction (breakers add μops
        # and execution resources, which is why this does not always help —
        # §5.3.1). Recorded separately; ``measured`` stays the canonical
        # breaker-free Def.-2 number (the paper reports CMC = 1, not 0.5).
        res.with_breakers = rest[0].cycles / 4
        rest = rest[1:]
    if spec.uses_divider:
        hi = None
        for n, c in zip(lens, rest):
            cyc = c.cycles / n
            hi = cyc if hi is None else min(hi, cyc)
        res.high_value = hi
    return res


def throughput_plan(spec: InstrSpec, isa: ISA,
                    value_hint: str = "low") -> MeasurementPlan:
    """§5.3.1 measured throughput as a single-wave plan."""
    return MeasurementPlan(_throughput_gen(spec, isa, value_hint),
                           name=f"throughput[{spec.name}]",
                           phase="throughput")


def measure_throughput(machine, isa: ISA, instr: InstrSpec | str,
                       value_hint: str = "low") -> ThroughputResult:
    """Run-to-completion wrapper over :func:`throughput_plan`."""
    spec = isa[instr] if isinstance(instr, str) else instr
    return run_plan(as_engine(machine), throughput_plan(spec, isa,
                                                        value_hint))


def computed_throughput(usage: PortUsage, spec: InstrSpec) -> float | None:
    """Intel-definition throughput from port usage (invalid for dividers)."""
    if spec.uses_divider or not usage.usage:
        return None
    return throughput_lp(usage.usage)
