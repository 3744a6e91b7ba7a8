"""Port-usage inference — Algorithm 1 of the paper (§5.1.2).

Measuring an instruction in isolation is ambiguous (2*p05 measures the same
as 1*p0+1*p5). The algorithm disambiguates by co-scheduling the instruction
with ``blockRep`` copies of a blocking instruction for each port combination
pc (processed smallest-first): μops of the instruction observed *on the
blocked ports* can run nowhere else; μops attributed to strict subsets pc'
in earlier iterations are subtracted (line 10 of Algorithm 1).

Includes both optimizations from the paper: iterate only over combinations
intersecting the isolation-measurement ports, and exit early once the
attributed μop count reaches the instruction's total μop count.

The algorithm is a :mod:`repro_torch.core.plan` measurement plan
(:func:`port_usage_plan`): the isolation run is one yield, then one yield
per combination-size tier — all |pc|=1 experiments in one batch, then
|pc|=2, ... Attribution (and the early exit) only ever depends on smaller
combinations, so batching within a tier is exact, and the early exit still
skips whole tiers of useless measurements. Under a
:class:`~repro_torch.core.plan.WaveScheduler`, many instructions' tiers fuse into
shared waves; :func:`infer_port_usage` remains the run-to-completion
wrapper over a single instruction's plan.

``n_ports`` (the machine's port count, a lower bound on blockRep) is the
one machine parameter a plan needs; wrappers fill it from the machine, and
:func:`~repro_torch.core.characterize.characterize_plan` threads it through.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import groupby

from repro_torch.core.blocking import BlockingSet
from repro_torch.core.engine import Experiment, as_engine
from repro_torch.core.isa import ISA, InstrSpec
from repro_torch.core.machine import (RegPool, fresh_instance,
                                      independent_experiment, ports_from_counters,
                                      uops_from_counters)
from repro_torch.core.plan import MeasurementPlan, run_plan

BLOCK_REP_CAP = 64


@dataclass
class PortUsage:
    """pu: port combination -> μop count, plus bookkeeping."""
    usage: dict = field(default_factory=dict)  # frozenset -> int
    total_uops: float = 0.0
    isolation: dict = field(default_factory=dict)

    def notation(self) -> str:
        """The paper's 3*p015+1*p23 notation."""
        parts = [f"{n}*p{''.join(sorted(pc))}"
                 for pc, n in sorted(self.usage.items(),
                                     key=lambda kv: sorted(kv[0]))]
        return "+".join(parts) if parts else "0"


def _port_usage_gen(spec: InstrSpec, isa: ISA, blocking: BlockingSet,
                    max_latency: int, n_ports: int, block_rep_cap: int):
    pool = RegPool()
    result = PortUsage()
    [iso] = yield [independent_experiment(spec, 12)]
    result.total_uops = round(uops_from_counters(iso, 12), 2)
    result.isolation = ports_from_counters(iso, 12)
    iso_ports = set(result.isolation)

    # optimization 1: only combinations whose ports appear in isolation
    combos = [pc for pc in blocking.combos() if pc & iso_ports]
    combos.sort(key=lambda pc: (len(pc), sorted(pc)))

    block_rep = min(max(8 * max_latency, n_ports), block_rep_cap)

    def blocked_experiment(pc) -> Experiment:
        blk_spec = isa[blocking.instrs[pc]]
        # the analyzed instruction's registers, kept apart from blockers'
        target = fresh_instance(spec, pool)
        avoid = set(target.regs.values())
        code = [fresh_instance(blk_spec, pool, avoid)
                for _ in range(block_rep)]
        code.append(target)
        return Experiment.of(code)

    attributed = 0
    for _, tier in groupby(combos, key=len):
        # optimization 2: early exit (checked per size tier — attribution
        # never depends on equal-or-larger combinations)
        if attributed >= round(result.total_uops):
            break
        tier = list(tier)
        counters = yield [blocked_experiment(pc) for pc in tier]
        for pc, c in zip(tier, counters):
            uops = sum(c.port_uops.get(p, 0.0) for p in pc)
            uops -= block_rep * blocking.uops_on_pc[pc]           # line 7
            for pc2, u2 in result.usage.items():                  # line 8-10
                if pc2 < pc:
                    uops -= u2
            uops_i = round(uops)
            if uops_i > 0:
                result.usage[pc] = uops_i
                attributed += uops_i
            if attributed >= round(result.total_uops):
                break
    return result


def port_usage_plan(spec: InstrSpec, isa: ISA, blocking: BlockingSet,
                    max_latency: int, *, n_ports: int,
                    block_rep_cap: int = BLOCK_REP_CAP) -> MeasurementPlan:
    """Algorithm 1 as a plan. ``max_latency``: max over the instruction's
    latency pairs (§5.2), used to size blockRep = 8 * maxLatency; ``n_ports``
    is the target machine's port count (lower bound on blockRep)."""
    return MeasurementPlan(
        _port_usage_gen(spec, isa, blocking, max_latency, n_ports,
                        block_rep_cap),
        name=f"ports[{spec.name}]", phase="ports")


def infer_port_usage(machine, isa: ISA, instr: InstrSpec | str,
                     blocking: BlockingSet, max_latency: int,
                     block_rep_cap: int = BLOCK_REP_CAP) -> PortUsage:
    """Algorithm 1, run to completion on one machine (wrapper over
    :func:`port_usage_plan`)."""
    engine = as_engine(machine)
    spec = isa[instr] if isinstance(instr, str) else instr
    return run_plan(engine, port_usage_plan(
        spec, isa, blocking, max_latency,
        n_ports=len(engine.machine.ports), block_rep_cap=block_rep_cap))
