"""Measurement protocol (Algorithm 2) and microbenchmark code generation.

``measure`` implements the paper's overhead-cancellation protocol: run the
benchmark body with n=10 and n=110 copies, difference the counters and divide
by 100. The machine's raw ``run`` includes harness overhead (serializing
instructions, counter reads — emulated by the simulator; real wall-clock
overhead on the hardware backend), so this differencing is doing real work.

``RegPool``/instance builders generate operand assignments with the
independence properties the paper's generators need: distinct registers per
operand, round-robin pools so repeated instances don't chain, and explicit
"avoid" sets so benchmark code never collides with the chain registers.

``run_batch`` is the wave-execution protocol between the measurement layer
and the machines: a machine may expose ``run_batch(codes) ->
list[Counters]`` to execute a whole wave of instruction sequences at once
(the compiled array backend in ``core/batch_sim.py`` — the default path
behind ``SimMachine``), and machines without it are driven by a scalar
per-sequence loop. ``MeasurementEngine.submit`` routes every deduplicated
miss-set through this protocol. Lock-aware machines additionally accept
``run_batch(codes, kernel_lock=...)``: the lock serializes GIL-bound
kernel execution (numpy backend, scalar fallback) while host
lowering/packing overlaps other workers' kernels; device backends ignore
it (their kernels release the GIL) and serialize dispatch on their own
per-device-subset lock instead, so machines placed on disjoint device
subsets overlap (see ``core/device_mesh.py``).
``machine_run_batch`` bridges machines that predate the parameter by
running them entirely under the lock.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

from repro_torch.core.engine import (N_LARGE, N_SMALL, Experiment, as_engine,
                                     machine_run_batch as run_batch)
from repro_torch.core.isa import FLAGS, GPR, IMM, MEM, VEC, InstrSpec
from repro_torch.core.simulator import Counters, Instr


def measure(machine, seq: list[Instr], n_small: int = N_SMALL,
            n_large: int = N_LARGE) -> Counters:
    """Per-copy cycles and per-port μop counts for one copy of ``seq``.

    Routed through the machine's :class:`~repro_torch.core.engine
    .MeasurementEngine`, so identical benchmarks are executed once per
    machine regardless of which inference algorithm requests them.
    ``machine`` may be a machine or an engine."""
    return as_engine(machine).measure(
        Experiment(tuple(seq), n_small, n_large))


@dataclass
class RegPool:
    """Round-robin architectural register pools per operand type."""
    n_gpr: int = 16
    n_vec: int = 16
    n_mem: int = 8

    def __post_init__(self):
        self._iters = {}

    def _names(self, otype: str):
        if otype == GPR:
            return [f"R{i}" for i in range(self.n_gpr)]
        if otype == VEC:
            return [f"X{i}" for i in range(self.n_vec)]
        if otype == MEM:
            return [f"RB{i}" for i in range(self.n_mem)]  # base registers
        if otype == FLAGS:
            return ["FLAGS"]
        return ["IMM"]

    def take(self, otype: str, avoid: set = frozenset()) -> str:
        it = self._iters.get(otype)
        if it is None:
            it = self._iters[otype] = itertools.cycle(self._names(otype))
        for _ in range(4 * len(self._names(otype))):
            r = next(it)
            if r not in avoid:
                return r
        raise RuntimeError(f"register pool exhausted for {otype}")


def fresh_instance(spec: InstrSpec, pool: RegPool,
                   avoid: set = frozenset(), value_hint: str = "low") -> Instr:
    """Instance with distinct registers per explicit operand (independent
    from ``avoid`` and, via round-robin, from recent instances)."""
    regs = {}
    used = set(avoid)
    for o in spec.explicit_operands:
        if o.otype == IMM:
            continue
        r = pool.take(o.otype, used)
        regs[o.name] = r
        used.add(r)
    return Instr(spec.name, regs, value_hint)


def independent_seq(spec: InstrSpec, pool: RegPool, n: int,
                    avoid: set = frozenset(),
                    value_hint: str = "low") -> list[Instr]:
    """n instances avoiding read-after-write dependencies as far as operand
    structure allows (§5.3.1): every instance gets fresh registers; implicit
    RMW operands (e.g. flags) cannot be decoupled — that is the point."""
    return [fresh_instance(spec, pool, avoid, value_hint) for _ in range(n)]


def flags_breaker(isa, pool: RegPool, avoid: set = frozenset()) -> Instr:
    """Dependency-breaking instruction for the status flags: overwrites all
    flags without reading them (TEST R, R on an independent register)."""
    spec = isa["TEST_R64_R64"]
    r = pool.take(GPR, avoid)
    return Instr(spec.name, {"op1": r, "op2": r})


def independent_experiment(spec: InstrSpec, n: int = 12,
                           value_hint: str = "low") -> Experiment:
    """Declarative experiment: ``n`` independent instances from a fresh
    register pool. Deterministic per (spec, n, hint) — which is exactly what
    makes μop counting and isolation measurement the *same* cache entry."""
    return Experiment.of(independent_seq(spec, RegPool(), n,
                                         value_hint=value_hint))


def uops_from_counters(c: Counters, n: int) -> float:
    return c.total_uops / n


def ports_from_counters(c: Counters, n: int,
                        eps: float = 0.05) -> dict[str, float]:
    return {p: v / n for p, v in c.port_uops.items() if v / n > eps}


def total_uops(machine, spec: InstrSpec, pool: RegPool | None = None,
               n: int = 12) -> float:
    """Average μop count of one instance, from independent repetitions."""
    if pool is None:
        c = as_engine(machine).measure(independent_experiment(spec, n))
    else:
        c = measure(machine, independent_seq(spec, pool, n))
    return uops_from_counters(c, n)


def _total_uops_gen(spec: InstrSpec, n: int):
    c = yield [independent_experiment(spec, n)]
    return uops_from_counters(c[0], n)


def total_uops_plan(spec: InstrSpec, n: int = 12):
    """:func:`total_uops` as a single-wave measurement plan — the same
    Experiment as the isolation run, so under a scheduler the μop count
    and Algorithm 1's isolation measurement share one execution."""
    from repro_torch.core.plan import MeasurementPlan  # noqa: PLC0415
    return MeasurementPlan(_total_uops_gen(spec, n),
                           name=f"uops[{spec.name}]", phase="uops")


def isolation_ports(machine, spec: InstrSpec, n: int = 12,
                    eps: float = 0.05) -> dict[str, float]:
    """Per-port μop distribution when run in isolation (the naive signal
    that §5.1 shows is ambiguous). Returns per-instance averages."""
    c = as_engine(machine).measure(independent_experiment(spec, n))
    return ports_from_counters(c, n, eps)
