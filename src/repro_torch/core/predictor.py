"""Static performance predictor — the open IACA/llvm-mca analogue the paper
ships on top of its measured models ("we have also implemented an
open-source performance-prediction tool similar to Intel's IACA", §9).

Given a :class:`PerfModel` and a loop body (list of Instr), predicts
steady-state cycles/iteration as the max of three bounds:

  * port bound      — LP over the summed port usage (§5.3.2),
  * latency bound   — loop-carried critical path through the per-operand-pair
                      latency map lat(s, d) (this is where the §4.1 latency
                      definition pays off: a scalar latency would overestimate
                      chains through fast operand pairs, e.g. AESDEC §7.3.1),
  * front-end bound — total μops / issue width.

``LegacyAnalyzer`` reproduces the *failure modes* the paper documents in
IACA (§7.2): it ignores status-flag and memory dependencies, models a single
scalar latency per instruction, and can carry stale port tables — used by
benchmarks to regenerate the paper's agreement-table methodology.

This module is the *single-block reference*: the batched service path
(service/batch_predictor.py) vectorizes the port and front-end bounds but
shares every scalar helper here (``sum_usage``, ``port_pressure``,
``classify_bottleneck``, ``_latency_bound``) and the port-bound entry point
in ``lp.py``, so batch and single-block predictions are bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.characterize import PerfModel
from repro_torch.core.isa import FLAGS, IMM, ISA, MEM
from repro_torch.core.lp import port_bound_from_usage, throughput_lp
from repro_torch.core.simulator import Instr


class UnknownInstructionError(KeyError):
    """A block references instruction variants absent from the model.

    This is an expected condition, not a bug: the paper's tool does not
    characterize every instruction (§8 — system, serializing, control-flow),
    and a model may come from a partial campaign. Carries the sorted list of
    ``missing`` variant names and the model's ``uarch`` so services can
    return it as a structured error instead of a bare KeyError."""

    def __init__(self, missing, uarch: str = ""):
        self.missing = sorted(set(missing))
        self.uarch = uarch
        super().__init__(f"model {uarch or '<unnamed>'} has no "
                         f"characterization for: {', '.join(self.missing)}")

    def __str__(self) -> str:  # KeyError.__str__ would re-quote the message
        return self.args[0]

    def __reduce__(self):  # KeyError's reduce would replay the message
        return (type(self), (self.missing, self.uarch))


def missing_specs(model: PerfModel, code, isa: ISA | None = None
                  ) -> list[str]:
    """Instruction variants used by ``code`` that cannot be predicted:
    absent from ``model``, or (with ``isa`` given) from the serving ISA —
    the latency bound needs the operand structure, not just measurements."""
    return sorted({i.spec for i in code
                   if i.spec not in model.instructions
                   or (isa is not None and i.spec not in isa)})


def check_block(model: PerfModel, code, isa: ISA | None = None) -> None:
    missing = missing_specs(model, code, isa)
    if missing:
        raise UnknownInstructionError(missing, model.uarch)


@dataclass
class Prediction:
    cycles: float
    port_bound: float
    latency_bound: float
    frontend_bound: float
    port_pressure: dict = field(default_factory=dict)
    bottleneck: str = ""


def sum_usage(model: PerfModel, code: list[Instr]):
    """Summed port-usage multiset and μop count of a block, in code order
    (the accumulation order is part of the reference semantics: the batch
    predictor reproduces it position by position)."""
    usage_sum: dict[frozenset, float] = {}
    uops = 0.0
    for ins in code:
        im = model[ins.spec]
        uops += im.uops
        if im.port_usage:
            for pc, n in im.port_usage.usage.items():
                usage_sum[pc] = usage_sum.get(pc, 0) + n
    return usage_sum, uops


def port_pressure(usage_sum: dict) -> dict:
    """Per-port pressure under an optimal balanced assignment.

    Combinations are visited in canonical order so the float accumulation
    is independent of dict insertion order — an in-memory model and its
    XML round trip must produce bit-identical pressures."""
    pressure: dict[str, float] = {}
    for pc, n in sorted(usage_sum.items(), key=lambda kv: sorted(kv[0])):
        for p in sorted(pc):
            pressure[p] = pressure.get(p, 0.0) + n / len(pc)
    return pressure


def classify_bottleneck(cycles: float, port_bound: float, lat_bound: float
                        ) -> str:
    """Deterministic tie-break: ports > latency > frontend."""
    if port_bound >= cycles - 1e-9:
        return "ports"
    if lat_bound >= cycles - 1e-9:
        return "latency"
    return "frontend"


def _resource_bounds(model: PerfModel, code: list[Instr], issue_width: int):
    usage_sum, uops = sum_usage(model, code)
    port_bound = port_bound_from_usage(usage_sum) if usage_sum else 0.0
    return port_bound, uops / issue_width, port_pressure(usage_sum)


def _latency_bound(model: PerfModel, isa: ISA, code: list[Instr],
                   iters: int = 24, *, track_flags: bool = True,
                   track_mem: bool = True, scalar_latency: bool = False):
    """Loop-carried dependency length per iteration: iterate the symbolic
    dataflow until the per-iteration increment stabilizes."""
    t: dict[str, float] = {}
    prev_max = 0.0
    inc = 0.0
    for it in range(iters):
        for ins in code:
            spec = isa[ins.spec]
            im = model[ins.spec]
            regs = dict(ins.regs)
            for o in spec.operands:
                regs.setdefault(o.name, "FLAGS" if o.otype == FLAGS
                                else f"IMPL_{o.name}")
            # measured dependency-breaking: some entry's same-register
            # cycles collapsed below latency => zero idiom (§7.3.6)
            ex = [regs[o.name] for o in spec.explicit_operands
                  if o.otype not in (IMM, MEM, FLAGS)]
            idiom = (not scalar_latency and len(ex) >= 2
                     and len(set(ex)) == 1 and im.latency is not None
                     and any(e.same_reg is not None and e.same_reg < 0.5
                             for e in im.latency.entries.values()))
            for d in spec.dests:
                if d.otype == FLAGS and not track_flags:
                    continue
                ready = 0.0
                for s in () if idiom else spec.sources:
                    if s.otype == IMM:
                        continue
                    if s.otype == FLAGS and not track_flags:
                        continue
                    if s.otype == MEM and not track_mem:
                        continue
                    e = im.latency.get(s.name, d.name) if im.latency else None
                    if e is None:
                        continue
                    if scalar_latency:
                        lat = im.latency.max_latency()
                    elif (e.same_reg is not None
                          and regs.get(s.name) == regs.get(d.name)
                          and s.name != d.name):
                        if e.same_reg < 0.5:  # measured dependency-breaking
                            continue
                        lat = e.same_reg
                    else:
                        lat = e.value
                    key = "MEM_" + regs[s.name] if s.otype == MEM else regs[s.name]
                    ready = max(ready, t.get(key, 0.0) + lat)
                key = "MEM_" + regs[d.name] if d.otype == MEM else regs[d.name]
                t[key] = ready
        cur_max = max(t.values(), default=0.0)
        inc = cur_max - prev_max
        prev_max = cur_max
    return inc


def predict(model: PerfModel, isa: ISA, code: list[Instr],
            issue_width: int = 4) -> Prediction:
    check_block(model, code, isa)
    port_bound, fe_bound, pressure = _resource_bounds(model, code, issue_width)
    lat_bound = _latency_bound(model, isa, code)
    cycles = max(port_bound, lat_bound, fe_bound)
    bn = classify_bottleneck(cycles, port_bound, lat_bound)
    return Prediction(cycles, port_bound, lat_bound, fe_bound, pressure, bn)


class LegacyAnalyzer:
    """IACA-with-its-documented-bugs (§7.2): ignores flag and memory
    dependencies, one scalar latency per instruction, optionally stale port
    tables (``port_overrides``: instr name -> {frozenset: count})."""

    def __init__(self, model: PerfModel, isa: ISA,
                 port_overrides: dict | None = None, issue_width: int = 4):
        self.model = model
        self.isa = isa
        self.port_overrides = port_overrides or {}
        self.issue_width = issue_width

    def predict(self, code: list[Instr]) -> Prediction:
        check_block(self.model, code, self.isa)
        usage_sum: dict[frozenset, float] = {}
        uops = 0.0
        for ins in code:
            im = self.model[ins.spec]
            usage = self.port_overrides.get(ins.spec,
                                            im.port_usage.usage
                                            if im.port_usage else {})
            uops += sum(usage.values())
            for pc, n in usage.items():
                usage_sum[pc] = usage_sum.get(pc, 0) + n
        port_bound = throughput_lp(usage_sum) if usage_sum else 0.0
        fe = uops / self.issue_width
        lat = _latency_bound(self.model, self.isa, code, track_flags=False,
                             track_mem=False, scalar_latency=True)
        cycles = max(port_bound, lat, fe)
        bn = ("ports" if port_bound >= cycles - 1e-9 else
              "latency" if lat >= cycles - 1e-9 else "frontend")
        return Prediction(cycles, port_bound, lat, fe, {}, bn)

    def port_usage_of(self, name: str):
        return self.port_overrides.get(
            name, self.model[name].port_usage.usage
            if self.model[name].port_usage else {})
