"""Full-ISA characterization: the paper's tool pipeline.

For every supported instruction variant:
  1. per-operand-pair latencies (§5.2)  — also provides maxLatency for 2.,
  2. port usage via Algorithm 1 (§5.1)  — needs the blocking instructions,
  3. measured throughput (§5.3.1) and LP throughput from port usage (§5.3.2).

The result (:class:`PerfModel`) is the machine-readable artifact (§6.4)
consumed by the predictor and exported to XML/JSON by ``model_io``.

The pipeline is a composite :mod:`repro_torch.core.plan` measurement plan
(:func:`characterize_plan`): blocking discovery and the latency boot fork
first, then one sub-plan per instruction fans out — each itself forking
latency / μop-count / throughput (port usage follows once the instruction's
maxLatency is known). Driven by a :class:`~repro_torch.core.plan.WaveScheduler`
(the default in :func:`characterize` and in ``Campaign``), a full-ISA run
interleaves *hundreds of instructions' experiments into each fused wave*
instead of one instruction's handful — the wave widths land in
``PerfModel.wave_stats``. Driven by :func:`~repro_torch.core.plan.run_plan`
(``sequential=True``), it reproduces the legacy per-instruction behavior
exactly; either way the measured results are identical, because experiments
are deterministic and the engine's cache/dedup semantics make execution
order invisible.

All measurement goes through the machine's :class:`MeasurementEngine`
(``machine`` may be a machine or an engine), so a characterization issues
no duplicate simulator executions: benchmarks shared between phases (μop
counting, isolation, Algorithm 1 setup) or repeated across runs are served
from the content-addressed cache. Per-phase wall time and the engine's
cache statistics are recorded on the model.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.blocking import BlockingSet, blocking_plan
from repro_torch.core.engine import as_engine, machine_fingerprint
from repro_torch.core.isa import ISA, InstrSpec
from repro_torch.core.latency import LatencyPlans, LatencyResult
from repro_torch.core.machine import total_uops_plan
from repro_torch.core.plan import (Fork, MeasurementPlan, SchedulerStats,
                                   WaveScheduler, run_plan)
from repro_torch.core.port_usage import PortUsage, port_usage_plan
from repro_torch.core.throughput import (ThroughputResult, computed_throughput,
                                         throughput_plan)
from repro_torch.obs import tracer as obs


@dataclass
class InstrModel:
    name: str
    uops: float = 0.0
    port_usage: PortUsage | None = None
    latency: LatencyResult | None = None
    throughput: ThroughputResult | None = None

    @property
    def max_latency(self) -> int:
        return self.latency.max_latency() if self.latency else 1


@dataclass
class PerfModel:
    uarch: str
    instructions: dict = field(default_factory=dict)  # name -> InstrModel
    blocking: dict = field(default_factory=dict)      # "p05" -> instr name
    run_seconds: float = 0.0
    phase_seconds: dict = field(default_factory=dict)  # phase -> seconds
    engine_stats: dict = field(default_factory=dict)   # cache/dedup counters
    wave_stats: dict = field(default_factory=dict)     # scheduler wave widths
    # content hash of the machine's hidden parameters at measurement time;
    # exported with the artifact so a registry can refuse to serve a model
    # measured on a different uarch definition (see service/registry.py)
    fingerprint: str = ""

    def __getitem__(self, name: str) -> InstrModel:
        return self.instructions[name]


def _supported(spec: InstrSpec) -> bool:
    """Paper §8 limitations: system / serializing / control-flow
    instructions are not characterized."""
    return not (spec.system or spec.serializing or spec.control_flow
                or spec.is_nop)


def _instruction_gen(spec: InstrSpec, isa: ISA, blocking: BlockingSet,
                     lat: LatencyPlans, n_ports: int):
    im = InstrModel(spec.name)
    # latency / μop count / throughput are mutually independent: fork them
    # so a scheduler fuses their waves (μop counting reuses Algorithm 1's
    # isolation experiment via the engine cache)
    im.latency, uops, im.throughput = yield Fork([
        lat.analyze_plan(spec),
        total_uops_plan(spec),
        throughput_plan(spec, isa),
    ])
    im.uops = round(uops, 2)
    # port usage needs maxLatency (blockRep sizing), hence runs after
    [im.port_usage] = yield Fork([
        port_usage_plan(spec, isa, blocking, im.max_latency,
                        n_ports=n_ports)])
    im.throughput.computed_from_ports = computed_throughput(
        im.port_usage, spec)
    return im


def instruction_plan(spec: InstrSpec, isa: ISA, blocking: BlockingSet,
                     lat: LatencyPlans, *, n_ports: int) -> MeasurementPlan:
    """Characterize one instruction (latency, μops, ports, throughput)."""
    return MeasurementPlan(_instruction_gen(spec, isa, blocking, lat,
                                            n_ports),
                           name=f"instr[{spec.name}]")


def _characterize_gen(isa: ISA, instr_names, blocking, n_ports: int):
    model = PerfModel("")
    lat = LatencyPlans(isa)
    if blocking is None:
        # separate SSE / AVX blocking sets (transition penalties, §5.1.1);
        # merged here since the simulated core has no penalty — the split
        # code path is exercised by dedicated tests. The latency boot rides
        # in the same fused wave as blocking discovery.
        blocking, _ = yield Fork([blocking_plan(isa, ("BASE", "SSE")),
                                  lat.boot_plan()])
    else:
        yield from lat.boot_gen()
    model.blocking = {"p" + "".join(sorted(pc)): nm
                      for pc, nm in blocking.instrs.items()}
    names = instr_names if instr_names is not None else isa.names()
    specs = [isa[n] for n in names if _supported(isa[n])]
    ims = yield Fork([instruction_plan(spec, isa, blocking, lat,
                                       n_ports=n_ports) for spec in specs])
    for im in ims:
        model.instructions[im.name] = im
    return model


def characterize_plan(isa: ISA, instr_names=None,
                      blocking: BlockingSet | None = None, *,
                      n_ports: int) -> MeasurementPlan:
    """The full pipeline as a composite plan (result: a :class:`PerfModel`
    whose machine-dependent fields — uarch name, fingerprint, stats — are
    filled in by the driver's wrapper). ``n_ports`` is the target machine's
    port count, threaded to Algorithm 1's blockRep sizing."""
    return MeasurementPlan(_characterize_gen(isa, instr_names, blocking,
                                             n_ports),
                           name="characterize")


def characterize(machine, isa: ISA, instr_names=None,
                 blocking: BlockingSet | None = None, *,
                 scheduler: WaveScheduler | None = None,
                 sequential: bool = False, cancel=None,
                 execute_lock=None) -> PerfModel:
    """Run-to-completion characterization of one machine.

    By default the composite plan is driven by a :class:`WaveScheduler`
    (pass ``scheduler`` to share one, e.g. per-campaign-worker; ``cancel``
    and ``execute_lock`` thread a cancellation event and a cross-worker
    wave-execution lock into a new scheduler). With ``sequential=True``
    the plan runs under :func:`run_plan` — the legacy per-instruction
    wave shape, kept as the reference/benchmark baseline."""
    if scheduler is not None and (cancel is not None
                                  or execute_lock is not None):
        raise ValueError("pass cancel/execute_lock when constructing the "
                         "shared scheduler, not alongside it (they would "
                         "be silently ignored)")
    if sequential and (scheduler is not None or cancel is not None
                       or execute_lock is not None):
        raise ValueError("sequential=True runs under run_plan, which "
                         "supports neither a scheduler nor "
                         "cancel/execute_lock")
    engine = as_engine(machine)
    if scheduler is not None and scheduler.engine is not engine:
        raise ValueError("the shared scheduler drives a different engine "
                         "than the machine being characterized (the model "
                         "would carry the wrong uarch/fingerprint)")
    stats0 = engine.stats.as_dict()
    t0 = time.time()
    with obs.span("characterize", uarch=engine.machine.name,
                  sequential=sequential) as span:
        return _run_characterize(engine, isa, instr_names, blocking,
                                 scheduler, sequential, cancel,
                                 execute_lock, stats0, t0, span)


def _run_characterize(engine, isa, instr_names, blocking, scheduler,
                      sequential, cancel, execute_lock, stats0, t0,
                      span) -> PerfModel:
    plan = characterize_plan(isa, instr_names, blocking,
                             n_ports=len(engine.machine.ports))
    if sequential:
        st = SchedulerStats()
        phases: dict = {}
        model = run_plan(engine, plan, stats=st, phase_seconds=phases)
        model.phase_seconds = {k: round(v, 6) for k, v in phases.items()}
        model.wave_stats = st.as_dict()
    else:
        sched = scheduler or WaveScheduler(engine, cancel=cancel,
                                           execute_lock=execute_lock)
        # the scheduler may be shared across characterize calls: report
        # this run's deltas, not scheduler-lifetime totals
        phases0 = dict(sched.phase_seconds)
        waves0, exps0, plans0 = (sched.stats.waves, sched.stats.experiments,
                                 sched.stats.plans_completed)
        model = sched.run_one(plan)
        model.phase_seconds = {
            k: round(v - phases0.get(k, 0.0), 6)
            for k, v in sched.phase_seconds.items()}
        d_waves = sched.stats.waves - waves0
        d_exps = sched.stats.experiments - exps0
        run_widths = sched.stats.wave_widths[waves0:]
        model.wave_stats = {
            "waves": d_waves, "experiments": d_exps,
            "plans_completed": sched.stats.plans_completed - plans0,
            "mean_wave_width": round(d_exps / max(1, d_waves), 2),
            "max_wave_width": max(run_widths, default=0)}
    model.uarch = engine.machine.name
    model.fingerprint = machine_fingerprint(engine.machine)
    model.run_seconds = time.time() - t0
    s1 = engine.stats.as_dict()
    # numeric counters delta against the run's baseline; non-numeric
    # telemetry (the "device" snapshot) is cumulative, carried as-is
    model.engine_stats = {
        k: (s1[k] - stats0.get(k, 0)
            if isinstance(s1[k], (int, float)) else s1[k])
        for k in s1 if k != "hit_rate"}
    req = model.engine_stats["requests"]
    hits = (model.engine_stats["cache_hits"]
            + model.engine_stats["dedup_hits"])
    model.engine_stats["hit_rate"] = round(hits / max(1, req), 4)
    span.set(instructions=len(model.instructions),
             waves=model.wave_stats.get("waves", 0),
             hit_rate=model.engine_stats["hit_rate"])
    return model
