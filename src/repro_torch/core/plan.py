"""Measurement plans: inference algorithms as resumable experiment generators.

The paper's algorithms (§5.1–§5.3) are naturally *experiment generators*:
each phase derives a set of microbenchmarks, runs them, and decides the next
set from the counters. This module makes that shape the public API of the
inference layer — the separation of experiment *selection* from experiment
*execution* that PALMED and Ritter & Reineke's explainable port-mapping work
use to scale throughput characterization.

The plan protocol
-----------------

A **plan** is a generator-based coroutine (optionally wrapped in
:class:`MeasurementPlan` for a name and a phase label). It communicates with
its driver exclusively through ``yield``:

* ``counters = yield [Experiment, ...]`` — request a batch of measurements;
  the driver resumes the plan with one :class:`Counters` per Experiment, in
  request order.
* ``results = yield Fork([plan, ...])`` — fan out sub-plans; the driver
  resumes the parent with the sub-plans' return values, in order. Sub-plans
  are themselves plans, so fan-out nests (characterize → instruction →
  latency pairs).
* ``return value`` — the plan's result (``StopIteration.value``).

Plans never touch a machine or an engine: they are pure descriptions of
*what to measure next given what was measured so far*. The same plan object
can therefore be driven two ways:

* :func:`run_plan` — the sequential reference driver: every yielded batch
  executes immediately, forked sub-plans run one after another. This is
  byte-for-byte the legacy (pre-plan) behavior of the inference modules, and
  it is what the thin compatibility wrappers (``infer_port_usage``,
  ``LatencyAnalyzer.analyze``, …) use.

* :class:`WaveScheduler` — the campaign driver: it steps *many* plans
  concurrently, drains every pending yield across all runnable plans, and
  executes the union as **one fused super-wave** through
  ``MeasurementEngine.submit`` (cache-first, deduplicated across plans,
  vectorized via the machine's ``run_batch`` backend). Because every
  runnable plan is stepped before any wave executes, no plan can starve —
  fairness is structural, not scheduled. A full-ISA characterization driven
  this way interleaves hundreds of instructions' experiments into each wave
  instead of one instruction's handful.

Results are identical under both drivers: experiments are deterministic
declarative objects, the engine's cache/dedup semantics make execution
order invisible, and the batched backend is bit-identical to the scalar
oracle — so regrouping experiments into wider waves can only change *when*
a benchmark runs, never what the inference concludes.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.engine import as_engine
from repro_torch.obs import tracer as obs


class PlanCancelled(RuntimeError):
    """Raised inside a driver when its cancel event is set (e.g. a sibling
    campaign worker failed); outstanding plans are closed first."""


class Fork:
    """Fan-out request: run these sub-plans concurrently (WaveScheduler) or
    sequentially (run_plan); the yield resumes with their results in order."""

    __slots__ = ("plans",)

    def __init__(self, plans):
        self.plans = list(plans)


class MeasurementPlan:
    """A named, phase-tagged resumable measurement computation.

    Thin wrapper around the underlying generator: ``iter(plan)`` returns the
    generator itself, so a plan composes into another plan with plain
    ``yield from`` and drives identically to a bare generator. ``phase``
    labels the plan for the scheduler's per-phase time attribution
    (inherited by forked children that don't carry their own)."""

    __slots__ = ("gen", "name", "phase")

    def __init__(self, gen, name: str = "", phase: str = ""):
        self.gen = gen
        self.name = name
        self.phase = phase

    def __iter__(self):
        return self.gen

    def __repr__(self):
        tag = f" phase={self.phase}" if self.phase else ""
        return f"<MeasurementPlan {self.name or 'anonymous'}{tag}>"


@dataclass
class SchedulerStats:
    """Wave-fusion telemetry: how wide the executed waves actually were."""

    waves: int = 0              # engine.submit calls issued
    experiments: int = 0        # Experiments across all waves (pre-dedup)
    plans_completed: int = 0    # plans (incl. forked children) run to return
    max_wave_width: int = 0
    wave_widths: list = field(default_factory=list)  # per-wave widths, in
    # order — lets a caller sharing one scheduler slice out its own run's
    # widths (see characterize()'s delta bookkeeping)

    def record(self, width: int) -> None:
        self.waves += 1
        self.experiments += width
        self.max_wave_width = max(self.max_wave_width, width)
        self.wave_widths.append(width)

    @property
    def mean_wave_width(self) -> float:
        return self.experiments / max(1, self.waves)

    def as_dict(self) -> dict:
        return {"waves": self.waves, "experiments": self.experiments,
                "plans_completed": self.plans_completed,
                "mean_wave_width": round(self.mean_wave_width, 2),
                "max_wave_width": self.max_wave_width}


class _Task:
    """One live plan inside a scheduler run."""

    __slots__ = ("gen", "phase", "parent", "index", "pending", "results",
                 "send")

    def __init__(self, plan, parent, index, phase):
        self.gen = iter(plan)      # the generator (plans return themselves)
        self.phase = phase
        self.parent = parent       # _Task waiting on this one, or None
        self.index = index         # slot in the parent's (or root) results
        self.pending = 0           # outstanding forked children
        self.results = None        # collected fork results
        self.send = None           # value to inject at the next step


class WaveScheduler:
    """Drive many measurement plans concurrently, fusing their experiment
    requests into campaign-wide super-waves.

    Each round: (1) *drain* — step every runnable plan until it blocks on a
    batch of experiments, forks sub-plans (children become runnable), or
    returns; (2) *execute* — concatenate all blocked plans' batches into one
    wave, run it through ``engine.submit`` (cache-first, deduplicated across
    plans, batched through the machine's ``run_batch``), and resume every
    blocked plan with its slice. Draining everything before executing
    anything is the fairness guarantee: a plan is never left behind while
    others consume measurements.

    ``cancel`` (a ``threading.Event``) aborts the run at the next round
    boundary with :class:`PlanCancelled` — campaign workers share one event
    so a failure on one machine stops the others promptly. Per-phase wall
    time lands in ``phase_seconds``: stepping time is attributed to the
    running plan's phase, wave-execution time proportionally to the number
    of experiments each phase contributed.

    ``execute_lock`` (a ``threading.Lock``) travels down to the machine's
    batched backend as a kernel lock (see ``machine_run_batch``) and
    serializes the *GIL-bound* kernels across schedulers that share it: a
    fused numpy super-wave is one large Python-stepped array program that
    already saturates the interpreter, so two campaign workers' kernels
    interleaving under the GIL just thrash each other (measured ~8x CPU
    inflation).  Host lowering and wave packing always run outside the
    lock, and plan stepping stays concurrent throughout.  Device backends
    (jax/pallas) do not take this lock at all: their compiled kernels
    release the GIL, and dispatch serializes on the backend's own
    *per-device-subset* lock (:func:`repro_torch.core.device_mesh
    .dispatch_lock`) instead — machines placed on disjoint device subsets
    by ``Campaign.run`` dispatch and execute concurrently, which is
    compute on distinct devices, not GIL thrash.
    """

    def __init__(self, machine_or_engine, *, cancel=None, execute_lock=None):
        self.engine = as_engine(machine_or_engine)
        self.cancel = cancel
        self.execute_lock = execute_lock
        self.stats = SchedulerStats()
        self.phase_seconds: dict[str, float] = {}

    # -- public entry points -----------------------------------------------
    def run(self, plans) -> list:
        """Drive ``plans`` to completion; returns their results in order.

        Each scheduler round emits two trace spans when tracing is on
        (``REPRO_TRACE=1``): ``scheduler.drain`` around the plan-stepping
        sweep and ``scheduler.execute`` around the fused wave (see
        :mod:`repro_torch.obs`)."""
        plans = list(plans)
        results: list = [None] * len(plans)
        ready: deque[_Task] = deque(
            _Task(p, None, i, getattr(p, "phase", ""))
            for i, p in enumerate(plans))
        blocked: list[tuple[_Task, list]] = []
        live: set[_Task] = set(ready)
        rounds = 0
        try:
            with obs.span("scheduler.run", plans=len(plans)) as sp:
                while ready or blocked:
                    if self.cancel is not None and self.cancel.is_set():
                        raise PlanCancelled("measurement campaign cancelled")
                    rounds += 1
                    with obs.span("scheduler.drain", plans=len(ready)):
                        while ready:
                            self._step(ready.popleft(), ready, blocked,
                                       results, live)
                    if blocked:
                        self._execute(blocked, ready)
                        blocked = []
                sp.set(rounds=rounds, waves=self.stats.waves)
        except BaseException:
            for t in live:
                try:
                    t.gen.close()
                except Exception:   # noqa: BLE001 - best-effort cleanup
                    pass
            raise
        return results

    def run_one(self, plan):
        return self.run([plan])[0]

    # -- internals ----------------------------------------------------------
    def _charge(self, phase: str, seconds: float) -> None:
        if phase:
            self.phase_seconds[phase] = (
                self.phase_seconds.get(phase, 0.0) + seconds)

    def _step(self, t: _Task, ready, blocked, results, live) -> None:
        send, t.send = t.send, None
        t0 = time.perf_counter()
        try:
            req = t.gen.send(send)
        except StopIteration as stop:
            self._charge(t.phase, time.perf_counter() - t0)
            self.stats.plans_completed += 1
            live.remove(t)
            self._deliver(t, stop.value, ready, results)
            return
        # other exceptions from inside a plan propagate to run(), which
        # closes every live generator before re-raising
        self._charge(t.phase, time.perf_counter() - t0)
        if isinstance(req, Fork):
            if not req.plans:
                t.send = []
                ready.append(t)
                return
            t.pending = len(req.plans)
            t.results = [None] * len(req.plans)
            for i, sub in enumerate(req.plans):
                child = _Task(sub, t, i, getattr(sub, "phase", "") or t.phase)
                live.add(child)
                ready.append(child)
            return
        batch = list(req)
        if not batch:
            t.send = []
            ready.append(t)
            return
        blocked.append((t, batch))

    def _deliver(self, t: _Task, value, ready, results) -> None:
        if t.parent is None:
            results[t.index] = value
            return
        parent = t.parent
        parent.results[t.index] = value
        parent.pending -= 1
        if parent.pending == 0:
            parent.send, parent.results = parent.results, None
            ready.append(parent)

    def _execute(self, blocked, ready) -> None:
        with obs.span("scheduler.fuse", plans=len(blocked)):
            wave: list = []
            for _, batch in blocked:
                wave.extend(batch)
        obs.counter("scheduler.wave_width", len(wave))
        t0 = time.perf_counter()
        # the shared lock travels down to the machine as a *kernel* lock:
        # only kernel execution serializes across schedulers; this
        # scheduler's host lowering/packing overlaps a sibling's kernel
        # (double-buffered async dispatch in the batched backend)
        with obs.span("scheduler.execute", wave=len(wave),
                      plans=len(blocked)):
            counters = self.engine.submit(wave,
                                          kernel_lock=self.execute_lock)
        dt = time.perf_counter() - t0
        self.stats.record(len(wave))
        off = 0
        for t, batch in blocked:
            n = len(batch)
            t.send = counters[off:off + n]
            off += n
            self._charge(t.phase, dt * n / len(wave))
            ready.append(t)


def run_plan(machine_or_engine, plan, stats: SchedulerStats | None = None,
             phase_seconds: dict | None = None):
    """Sequential reference driver: run one plan to completion.

    Every yielded batch executes immediately as its own wave; forked
    sub-plans run one after another, depth-first. This reproduces the
    legacy per-instruction behavior exactly (phase-local waves, no fusion
    across plans) and is what the compatibility wrappers use. ``stats``
    optionally records the executed wave widths for comparison against a
    :class:`WaveScheduler` run; ``phase_seconds`` optionally accumulates
    per-phase wall time (phase labels inherit into forked children, as in
    the scheduler)."""
    engine = as_engine(machine_or_engine)

    def charge(phase: str, seconds: float) -> None:
        if phase_seconds is not None and phase:
            phase_seconds[phase] = phase_seconds.get(phase, 0.0) + seconds

    def drive(p, phase: str = ""):
        gen = iter(p)
        phase = getattr(p, "phase", "") or phase
        send = None
        while True:
            t0 = time.perf_counter()
            try:
                req = gen.send(send)
            except StopIteration as stop:
                charge(phase, time.perf_counter() - t0)
                if stats is not None:
                    stats.plans_completed += 1
                return stop.value
            charge(phase, time.perf_counter() - t0)
            if isinstance(req, Fork):
                send = [drive(sub, phase) for sub in req.plans]
            else:
                batch = list(req)
                t0 = time.perf_counter()
                send = engine.submit(batch) if batch else []
                charge(phase, time.perf_counter() - t0)
                if stats is not None and batch:
                    stats.record(len(batch))

    return drive(plan)
