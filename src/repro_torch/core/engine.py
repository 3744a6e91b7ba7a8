"""Batched experiment engine: the measurement layer behind Algorithm 2.

The paper's tool (§3.3, Algorithm 2) treats the processor as a black box
queried by thousands of auto-generated microbenchmarks: serialize the
benchmark body n times, read the performance counters before and after, and
difference two run lengths (n=10 vs n=110) to cancel the constant harness
overhead. This module reifies that protocol as data instead of control flow:

* :class:`Experiment` — one microbenchmark *described declaratively*: the
  instruction sequence (Algorithm 2's benchmark body) plus the protocol
  parameters (the two unroll counts). An Experiment says *what* to measure,
  never *how* or *where*; the same object can be executed on any machine.

* :class:`MeasurementEngine` — executes Experiments against one machine
  through a content-addressed result cache. The cache key is
  ``uarch name + canonicalized instruction sequence + run params``, so two
  inference algorithms that independently generate the same microbenchmark
  (e.g. μop counting in ``characterize`` and in Algorithm 1's setup) share
  one execution. ``submit`` takes a whole wave of independent Experiments,
  dedups identical requests, and hands the unique miss-set to the machine
  *as one wave* through the ``run_batch`` protocol (see ``machine.py``):
  machines with a compiled batched backend (``batch_sim.BatchSimMachine``,
  the default behind ``SimMachine.run_batch``) execute the whole wave as a
  single vectorized array program; machines without one fall back to a
  per-experiment scalar loop. Either way the results are bit-identical —
  the batch backend is differential-tested against the scalar oracle.
  The in-memory cache is LRU-bounded (``max_entries``, eviction count in
  ``stats``) so long service-backed campaigns cannot grow without limit;
  persisted caches are unaffected.

* :class:`Campaign` — a full characterization run over *several* machines
  (microarchitectures) at once: the paper's per-uarch tool invocations,
  sharded across a thread pool, with per-uarch engines whose caches can be
  persisted (via ``model_io``) so re-runs are incremental. Each worker
  drives the composite characterization plan through one
  :class:`~repro_torch.core.plan.WaveScheduler`, and a shared cancellation event
  makes the first worker failure cancel its siblings cleanly.

The inference algorithms (blocking / port_usage / latency / throughput /
characterize) are expressed as *measurement plans* (see ``core/plan.py``):
resumable coroutines that yield batches of Experiments and receive their
Counters; none of them calls ``machine.run`` directly anymore. A
``WaveScheduler`` drains many plans' pending yields into fused super-waves
through ``submit``, so dedup/cache sharing happens *across* concurrently
scheduled plans, not just within one algorithm's batch. ``engine.stats``
counts requests, hits, and executions — the invariant that no duplicate
simulator execution ever happens is testable, not aspirational.
"""
from __future__ import annotations

import hashlib
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field

from repro_torch.core.simulator import Counters, Instr
from repro_torch.faults import plan as faults
from repro_torch.faults.plan import InjectedFault
from repro_torch.obs import tracer as obs

# Algorithm 2 protocol defaults: the two unroll counts whose difference
# cancels the constant measurement-harness overhead.
N_SMALL = 10
N_LARGE = 110

# in-memory cache bound (entries). Characterization campaigns stay far
# below this; it exists so service-backed engines fed unbounded query
# streams cannot grow without limit.
DEFAULT_CACHE_ENTRIES = 1 << 18


# ---------------------------------------------------------------------------
# canonical form / content addressing
# ---------------------------------------------------------------------------


def _canon_uop(u) -> tuple:
    return (sorted(u.ports), u.reads, u.writes, u.latency, u.occupancy)


def _canon_behavior(b) -> tuple:
    return (tuple(_canon_uop(u) for u in b.uops),
            _canon_behavior(b.same_reg) if b.same_reg else None,
            b.elim_period, b.dep_breaking_same_reg, b.zero_uop_same_reg,
            b.divider_extra)


def machine_fingerprint(machine) -> str:
    """Content hash of the machine's hidden parameters (uarch tables).

    Persisted caches carry this fingerprint: measurements are only valid
    for the exact machine that produced them, so an edit to a uarch
    definition (or a machine without ground-truth tables) invalidates the
    cache instead of silently replaying stale counters."""
    ua = getattr(machine, "uarch", None)
    if ua is None:
        payload = f"opaque:{machine.name}"
    else:
        payload = repr((ua.name, sorted(ua.ports), ua.issue_width,
                        ua.load_latency, ua.store_forward_latency,
                        ua.overhead_cycles, ua.partial_stall_penalty,
                        sorted((n, _canon_behavior(b))
                               for n, b in ua.behaviors.items())))
    return hashlib.sha256(payload.encode()).hexdigest()


def canonical_instr(ins: Instr) -> str:
    """Stable text form of one instruction instance (operand order-free)."""
    regs = ",".join(f"{k}={v}" for k, v in sorted(ins.regs.items()))
    return f"{ins.spec}({regs})#{ins.value_hint}"


def canonical_code(code) -> str:
    return ";".join(canonical_instr(i) for i in code)


@dataclass(frozen=True)
class Experiment:
    """One declarative microbenchmark: body + Algorithm 2 run parameters."""
    code: tuple  # tuple[Instr, ...]
    n_small: int = N_SMALL
    n_large: int = N_LARGE

    @classmethod
    def of(cls, code, n_small: int = N_SMALL,
           n_large: int = N_LARGE) -> "Experiment":
        return cls(tuple(code), n_small, n_large)

    def cache_key(self, uarch: str) -> str:
        """Content-addressed key: uarch + canonical sequence + run params."""
        payload = f"{uarch}|{self.n_small}/{self.n_large}|" \
                  f"{canonical_code(self.code)}"
        return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class QuarantinedExperiment:
    """One experiment isolated by bisecting retry: its wave failed, the
    engine split until the failure pinned to this experiment alone, and
    the campaign carried on without it. The record is the postmortem
    handle — the cache key replays the exact microbenchmark, ``error``
    names the terminal exception (for injected faults that includes the
    fault point + occurrence, which replays the chaos schedule)."""
    uarch: str
    cache_key: str
    code: str    # canonical body (truncated for reporting)
    error: str   # "ExcType: message"

    def as_dict(self) -> dict:
        return {"uarch": self.uarch, "cache_key": self.cache_key,
                "code": self.code, "error": self.error}


class QuarantinedResult(Counters):
    """Sentinel Counters returned for a quarantined experiment: NaN
    cycles, no port uops. Never persisted to the engine cache — a later
    submit of the same experiment re-executes it."""


def is_quarantined(c: Counters) -> bool:
    return isinstance(c, QuarantinedResult)


@dataclass
class EngineStats:
    requests: int = 0      # Experiments submitted
    cache_hits: int = 0    # served from a previously executed result
    dedup_hits: int = 0    # duplicates within a single submitted wave
    executions: int = 0    # unique Experiments actually executed
    machine_runs: int = 0  # raw machine runs (2 per execution)
    batches: int = 0
    evictions: int = 0     # cache entries dropped by the LRU bound
    # machine-side lowering-cache counters: this engine's share of the
    # batched backend's totals (deltas against a baseline snapshot taken
    # before the engine's first executed wave, so a machine reused across
    # engines/campaigns does not leak prior runs' counts), refreshed
    # after every executed wave.  Warm waves skip Python lowering
    # entirely when these hit
    lowering_hits: int = 0
    lowering_misses: int = 0
    lowering_evictions: int = 0
    # resilience counters: experiments isolated + dropped by bisecting
    # retry, sub-wave retry rounds spent isolating them, and chunks the
    # machine degraded to a lower backend after a kernel fault (snapshot
    # of the backend's per-transition counters in ``degraded``)
    quarantined: int = 0
    bisect_retries: int = 0
    degraded_chunks: int = 0
    # the typed records behind ``quarantined`` (QuarantinedExperiment);
    # non-numeric, surfaced via ``as_dict()["quarantine"]`` only when
    # non-empty so clean runs keep the legacy shape byte-identical
    quarantine: list = field(default_factory=list)
    degraded: dict = field(default_factory=dict)
    # machine-side device-kernel telemetry: the batched backend's
    # ``device_stats()`` snapshot (compile/kernel-call totals plus the
    # ``per_device`` counters, keyed by device name), refreshed after
    # every executed wave.  Non-numeric — delta consumers (characterize's
    # engine_stats) skip it; ``bench_backend_matrix`` and the CI recompile
    # probe read it for cross-device recompiles
    device: dict = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        return (self.cache_hits + self.dedup_hits) / max(1, self.requests)

    def to_registry(self, reg=None):
        """Publish these stats as canonical ``engine.*`` instruments on a
        :class:`repro_torch.obs.metrics.MetricsRegistry` (see
        ``repro_torch.obs.metrics.ENGINE_ALIASES`` for the legacy-key mapping)."""
        from repro_torch.obs import metrics as obs_metrics  # noqa: PLC0415
        if reg is None:
            reg = obs_metrics.MetricsRegistry()
        reg.gauge("engine.requests").set(self.requests)
        reg.gauge("engine.cache.hits").set(self.cache_hits)
        reg.gauge("engine.cache.dedup_hits").set(self.dedup_hits)
        reg.gauge("engine.executions").set(self.executions)
        reg.gauge("engine.machine_runs").set(self.machine_runs)
        reg.gauge("engine.batches").set(self.batches)
        reg.gauge("engine.cache.evictions").set(self.evictions)
        reg.gauge("engine.lowering.hits").set(self.lowering_hits)
        reg.gauge("engine.lowering.misses").set(self.lowering_misses)
        reg.gauge("engine.lowering.evictions").set(self.lowering_evictions)
        reg.gauge("engine.quarantined").set(self.quarantined)
        reg.gauge("engine.bisect_retries").set(self.bisect_retries)
        reg.gauge("engine.degraded_chunks").set(self.degraded_chunks)
        reg.gauge("engine.cache.hit_rate").set(round(self.hit_rate, 4))
        if self.device:
            obs_metrics.absorb_device_stats(reg, self.device)
        return reg

    def as_dict(self) -> dict:
        """The legacy flat stats shape, now *derived from* the canonical
        metrics registry: every key here is a documented alias of an
        ``engine.*`` instrument (``repro_torch.obs.metrics.ENGINE_ALIASES``);
        ``device`` carries the backend's nested telemetry verbatim."""
        from repro_torch.obs import metrics as obs_metrics  # noqa: PLC0415
        out = obs_metrics.legacy_engine_dict(self.to_registry())
        out["device"] = dict(self.device)
        # resilience details only when something actually happened, so
        # clean runs keep the historical shape exactly
        if self.quarantine:
            out["quarantine"] = [q.as_dict() for q in self.quarantine]
        if self.degraded:
            out["degraded"] = dict(self.degraded)
        return out


def _takes_kernel_lock(fn) -> bool:
    """Does this ``run_batch`` speak the kernel-lock protocol?  Cached per
    underlying function (custom machines in tests often define a bare
    ``run_batch(codes)``)."""
    probe = getattr(fn, "__func__", fn)
    hit = _LOCK_SIG_CACHE.get(probe)
    if hit is None:
        import inspect  # noqa: PLC0415
        try:
            hit = "kernel_lock" in inspect.signature(probe).parameters
        except (TypeError, ValueError):
            hit = False
        _LOCK_SIG_CACHE[probe] = hit
    return hit


_LOCK_SIG_CACHE: dict = {}


def machine_run_batch(machine, codes, kernel_lock=None) -> list[Counters]:
    """The wave-execution protocol: machines exposing ``run_batch`` get the
    whole wave at once (vectorized backends); plain machines fall back to
    a per-sequence scalar loop. Re-exported by ``machine.py``.

    ``kernel_lock`` serializes GIL-bound kernel execution across callers
    that share it: lock-aware machines hold it while a Python-stepped
    kernel runs but only around *dispatch* for GIL-releasing device
    kernels (host lowering/packing always overlaps); machines that
    predate the protocol — or the scalar loop — are executed entirely
    under the lock."""
    run_batch = getattr(machine, "run_batch", None)
    if run_batch is not None:
        if kernel_lock is not None and not _takes_kernel_lock(run_batch):
            # legacy machine: whole wave under the lock (wait time traced
            # separately so cross-engine contention is visible)
            with obs.wait_lock(kernel_lock, "wave.lock_wait"):
                return run_batch(codes)
        if kernel_lock is not None:
            return run_batch(codes, kernel_lock=kernel_lock)
        return run_batch(codes)
    if kernel_lock is not None:
        with obs.wait_lock(kernel_lock, "wave.lock_wait"):
            return [machine.run(list(c)) for c in codes]
    return [machine.run(list(c)) for c in codes]


class MeasurementEngine:
    """Cached, deduplicating, wave-batching executor of Experiments on one
    machine. ``max_entries`` bounds the in-memory cache (LRU); ``None``
    disables the bound."""

    def __init__(self, machine, cache: dict | None = None, *,
                 enabled: bool = True,
                 max_entries: int | None = DEFAULT_CACHE_ENTRIES):
        self.machine = machine
        self.cache: dict[str, Counters] = {} if cache is None else cache
        self.enabled = enabled
        self.max_entries = max_entries
        # bisecting retry gives up (re-raises) past this many quarantined
        # experiments: a failure that survives hundreds of isolations is a
        # broken backend, not poisoned experiments
        self.max_quarantine = 256
        self.stats = EngineStats()
        self._lock = threading.Lock()
        # lowering-counter baseline: the backend stats dict we snapshotted
        # (identity-tracked — set_table_index rebuilds the machine's
        # batched backend, restarting its counters, so a stale baseline
        # would report negative deltas) and its totals at snapshot time
        self._lowering_src = None
        self._lowering_base: dict = {}

    # -- single experiment -------------------------------------------------
    def measure(self, exp: Experiment) -> Counters:
        return self.submit([exp])[0]

    # -- batched wave ------------------------------------------------------
    def submit(self, experiments, kernel_lock=None) -> list[Counters]:
        """Execute a wave of independent Experiments; identical requests are
        deduplicated and cached results reused; the unique miss-set runs as
        one batch through the machine's ``run_batch`` protocol. Returns one
        Counters per submitted Experiment, in submission order.
        ``kernel_lock`` serializes kernel execution across engines sharing
        it (host lowering/packing stays concurrent, see
        :func:`machine_run_batch`)."""
        experiments = list(experiments)
        uarch = self.machine.name
        with obs.span("engine.submit", uarch=uarch,
                      wave=len(experiments)) as sp:
            keys = [e.cache_key(uarch) for e in experiments]
            with self._lock:
                self.stats.requests += len(experiments)
                self.stats.batches += 1
                if not self.enabled:
                    with obs.span("engine.miss_wave",
                                  misses=len(experiments)):
                        return self._execute_wave(experiments, kernel_lock)
                todo: dict[str, Experiment] = {}
                resolved: dict[str, Counters] = {}
                with obs.span("engine.cache_probe", wave=len(experiments)):
                    for e, k in zip(experiments, keys):
                        if k in self.cache:
                            self.stats.cache_hits += 1
                            resolved[k] = self.cache[k] = \
                                self.cache.pop(k)  # touch
                        elif k in todo:
                            self.stats.dedup_hits += 1
                        else:
                            todo[k] = e
                sp.set(hits=len(experiments) - len(todo), misses=len(todo))
                if todo:
                    with obs.span("engine.miss_wave", misses=len(todo)):
                        for k, c in zip(todo,
                                        self._execute_wave(todo.values(),
                                                           kernel_lock)):
                            resolved[k] = c
                            if not is_quarantined(c):
                                self._store(k, c)
                obs.counter("engine.hit_rate",
                            round(self.stats.hit_rate, 4))
                return [self._copy(resolved[k]) for k in keys]

    def _store(self, key: str, c: Counters) -> None:
        self.cache[key] = c
        if self.max_entries is not None:
            while len(self.cache) > self.max_entries:
                self.cache.pop(next(iter(self.cache)))  # oldest entry
                self.stats.evictions += 1

    # -- Algorithm 2: overhead-cancelling differenced runs, one wave -------
    def _execute_wave(self, experiments, kernel_lock=None) -> list[Counters]:
        """Execute a miss-wave with bisecting-retry resilience: if the
        fused wave fails, split it and retry the halves until the
        failure pins to single experiments, which are quarantined
        (typed :class:`QuarantinedExperiment` records on ``stats``,
        :class:`QuarantinedResult` sentinels in the result slots — never
        cached) instead of aborting the campaign. A clean wave pays
        nothing: the try/except only costs when a kernel actually
        raises."""
        experiments = list(experiments)
        try:
            return self._run_experiments(experiments, kernel_lock)
        except Exception as exc:
            return self._bisect_wave(experiments, kernel_lock, exc)

    def _bisect_wave(self, experiments, kernel_lock, exc) -> list[Counters]:
        if len(experiments) == 1:
            return [self._quarantine(experiments[0], exc)]
        self.stats.bisect_retries += 1
        mid = len(experiments) // 2
        out: list[Counters] = []
        for half in (experiments[:mid], experiments[mid:]):
            try:
                with obs.span("engine.bisect_retry", wave=len(half)):
                    out.extend(self._run_experiments(half, kernel_lock))
            except Exception as e2:
                out.extend(self._bisect_wave(half, kernel_lock, e2))
        return out

    def _quarantine(self, e: Experiment, exc: BaseException) -> Counters:
        if self.stats.quarantined >= self.max_quarantine:
            # a failure that survives this many isolations is systemic
            # (broken backend, not poisoned experiments): stop eating it
            raise exc
        rec = QuarantinedExperiment(
            uarch=self.machine.name,
            cache_key=e.cache_key(self.machine.name),
            code=canonical_code(e.code)[:200],
            error=f"{type(exc).__name__}: {exc}")
        self.stats.quarantined += 1
        self.stats.quarantine.append(rec)
        obs.instant("engine.quarantine", uarch=rec.uarch, error=rec.error)
        warnings.warn(f"quarantined experiment on {rec.uarch} "
                      f"({rec.code[:60]}...): {rec.error}", stacklevel=2)
        return QuarantinedResult(float("nan"), {})

    def _run_experiments(self, experiments, kernel_lock=None) \
            -> list[Counters]:
        experiments = list(experiments)
        ls0 = getattr(self.machine, "lowering_stats", None)
        if ls0 and ls0 is not self._lowering_src:
            # first sight of this backend's counter dict (machine warmed
            # by prior engines, or its backend rebuilt since our last
            # wave): snapshot a baseline — work counted before this
            # engine's next wave is not this engine's
            self._lowering_src = ls0
            self._lowering_base = dict(ls0)
        codes: list = []
        for e in experiments:
            codes.append(list(e.code) * e.n_small)
            codes.append(list(e.code) * e.n_large)
        raw = machine_run_batch(self.machine, codes, kernel_lock)
        self.stats.machine_runs += len(codes)
        self.stats.executions += len(experiments)
        ls = getattr(self.machine, "lowering_stats", None)
        if ls:   # this engine's share of the backend's lifetime totals
            if ls is not self._lowering_src:
                # the backend materialized (or was rebuilt) during this
                # wave: everything it counted happened in this wave
                self._lowering_src = ls
                self._lowering_base = {}
            base = self._lowering_base
            self.stats.lowering_hits = ls["hits"] - base.get("hits", 0)
            self.stats.lowering_misses = (ls["misses"]
                                          - base.get("misses", 0))
            self.stats.lowering_evictions = (ls["evictions"]
                                             - base.get("evictions", 0))
        ds = getattr(self.machine, "device_stats", None)
        if ds is not None:   # device-kernel telemetry snapshot (see stats)
            self.stats.device = ds() or {}
        dg = getattr(self.machine, "degraded_stats", None)
        if dg is not None:   # backend-degradation counters snapshot
            self.stats.degraded = dg() or {}
            self.stats.degraded_chunks = sum(self.stats.degraded.values())
        out = []
        for i, e in enumerate(experiments):
            c1, c2 = raw[2 * i], raw[2 * i + 1]
            d = e.n_large - e.n_small
            ports = {p: (c2.port_uops.get(p, 0) - c1.port_uops.get(p, 0)) / d
                     for p in set(c1.port_uops) | set(c2.port_uops)}
            out.append(Counters((c2.cycles - c1.cycles) / d, ports))
        return out

    @staticmethod
    def _copy(c: Counters) -> Counters:
        # type(c), not Counters: quarantined sentinels stay identifiable
        # through the copy callers receive
        return type(c)(c.cycles, dict(c.port_uops))


def as_engine(machine_or_engine) -> MeasurementEngine:
    """Adapt either a machine or an engine to an engine.

    A machine gets one persistent engine attached on first use, so every
    code path measuring on that machine — including legacy ``measure()``
    callers — shares a single cache."""
    if isinstance(machine_or_engine, MeasurementEngine):
        return machine_or_engine
    eng = getattr(machine_or_engine, "_engine", None)
    if eng is None:
        eng = MeasurementEngine(machine_or_engine)
        machine_or_engine._engine = eng
    return eng


# ---------------------------------------------------------------------------
# campaigns: multi-uarch characterization
# ---------------------------------------------------------------------------


@dataclass
class CampaignResult:
    models: dict = field(default_factory=dict)         # uarch -> PerfModel
    stats: dict = field(default_factory=dict)          # uarch -> stats dict
    phase_seconds: dict = field(default_factory=dict)  # uarch -> phase -> s
    uarch_seconds: dict = field(default_factory=dict)  # uarch -> CPU s
    wave_stats: dict = field(default_factory=dict)     # uarch -> wave widths
    # uarch -> [QuarantinedExperiment.as_dict()] for experiments isolated
    # by bisecting retry (only uarches that quarantined anything appear)
    quarantine: dict = field(default_factory=dict)
    wall_seconds: float = 0.0  # campaign wall; per-uarch values are
    # thread CPU seconds (comparable across runs regardless of sharding)

    @property
    def quarantined(self) -> int:
        return sum(len(v) for v in self.quarantine.values())

    @property
    def mean_wave_width(self) -> float:
        """Campaign-wide mean fused-wave width (experiments per submit)."""
        exps = sum(w.get("experiments", 0) for w in self.wave_stats.values())
        waves = sum(w.get("waves", 0) for w in self.wave_stats.values())
        return exps / max(1, waves)

    @property
    def hit_rate(self) -> float:
        req = sum(s["requests"] for s in self.stats.values())
        hit = sum(s["cache_hits"] + s["dedup_hits"]
                  for s in self.stats.values())
        return hit / max(1, req)

    def report(self) -> str:
        lines = [f"{'uarch':10s} {'#instr':>6s} {'cpu_s':>7s} "
                 f"{'hit%':>6s} {'execs':>6s}"]
        for name, model in sorted(self.models.items()):
            s = self.stats[name]
            lines.append(
                f"{name:10s} {len(model.instructions):6d} "
                f"{self.uarch_seconds[name]:7.1f} "
                f"{100 * s['hit_rate']:6.1f} {s['executions']:6d}")
        lines.append(f"total wall: {self.wall_seconds:.1f}s, "
                     f"overall hit rate {100 * self.hit_rate:.1f}%")
        if self.quarantine:
            lines.append(f"quarantined experiments: {self.quarantined} "
                         f"({', '.join(sorted(self.quarantine))})")
        return "\n".join(lines)


class Campaign:
    """Characterize several machines concurrently through cached engines.

    Each machine's worker drives the composite characterization plan
    through its own :class:`~repro_torch.core.plan.WaveScheduler`, so every
    uarch's experiments fuse into campaign-wide super-waves (wave-width
    telemetry lands in ``CampaignResult.wave_stats``). Workers share one
    cancellation event: the first failure cancels the sibling schedulers at
    their next wave boundary and the original exception (with its
    traceback) propagates from :meth:`run` instead of a hung pool or a
    partially populated result.

    ``cache_dir`` enables the persistent cache: each machine's engine cache
    is loaded before and saved after its characterization (serialized by
    ``model_io``), making ``characterize`` re-runs incremental across
    processes."""

    def __init__(self, instr_names=None, cache_dir=None,
                 max_workers: int | None = None):
        self.instr_names = instr_names
        self.cache_dir = cache_dir
        self.max_workers = max_workers

    def _cache_path(self, uarch: str):
        from pathlib import Path  # noqa: PLC0415
        return Path(self.cache_dir) / f"{uarch}.meas.json"

    def _run_one(self, machine, isa, cancel, execute_lock):
        from repro_torch.core import model_io  # noqa: PLC0415
        from repro_torch.core.characterize import characterize  # noqa: PLC0415

        engine = as_engine(machine)
        with obs.span("campaign.worker", uarch=machine.name) as sp:
            if self.cache_dir is not None:
                path = self._cache_path(machine.name)
                if path.exists():
                    try:
                        with obs.span("campaign.cache_load",
                                      uarch=machine.name):
                            faults.check("engine.cache_io",
                                         key=f"load:{path.name}")
                            engine.cache.update(
                                model_io.load_measurement_cache(
                                    path, expect_fingerprint=
                                    machine_fingerprint(machine)))
                    except (ValueError, KeyError, OSError,
                            InjectedFault) as e:
                        # a cache is disposable: corruption (incl. a torn
                        # write from a previous crash) or a changed
                        # machine means cold, not dead (the save below
                        # rewrites it)
                        warnings.warn(f"ignoring unusable measurement cache "
                                      f"{path}: {e}", stacklevel=2)
            # thread CPU time: under the GIL the machines' threads
            # interleave, so wall clock per uarch would just re-measure the
            # whole campaign
            t0 = time.thread_time()
            model = characterize(engine, isa, self.instr_names, cancel=cancel,
                                 execute_lock=execute_lock)
            dt = time.thread_time() - t0
            sp.set(cpu_s=round(dt, 3),
                   instructions=len(model.instructions))
            if self.cache_dir is not None:
                try:
                    with obs.span("campaign.cache_save", uarch=machine.name):
                        model_io.save_measurement_cache(
                            self._cache_path(machine.name), engine)
                except (OSError, InjectedFault) as e:
                    # losing the persistent cache costs the next run
                    # warmth, never this run's model
                    warnings.warn(f"measurement cache save failed for "
                                  f"{machine.name}: {e}", stacklevel=2)
        return model, engine, dt

    def run(self, machines, isa) -> CampaignResult:
        """Top-level entry point: one characterization per machine, sharded
        across a thread pool (the machines are independent black boxes).

        Machines that support it share one compiled μop-table index, so
        every uarch's batched backend uses the same instruction numbering
        (one table set per campaign, not per machine) — and are placed on
        **disjoint device subsets** when the placement
        (``REPRO_SIM_DEVICES``, else every card) has at least one device a
        machine (see :func:`repro_torch.core.device_mesh.partition`): each
        uarch's waves then execute on its own devices under its own
        dispatch lock,
        so a multi-uarch campaign is wall-clock-bound by one uarch rather
        than serialized behind a shared device.  With one (or no) device
        every machine keeps the default placement; results are
        bit-identical either way."""
        machines = list(machines)
        try:
            from repro_torch.core.uarch_compile import UopTableIndex  # noqa: PLC0415
            index = UopTableIndex.for_isa(isa)
        except ImportError:   # no numpy: machines fall back to scalar runs
            index = None
        if index is not None:
            for m in machines:
                setter = getattr(m, "set_table_index", None)
                if setter is not None:
                    setter(index)
        from repro_torch.core.device_mesh import (  # noqa: PLC0415
                  partition, resolve_devices)
        placement = partition(resolve_devices(), len(machines))
        for m, group in zip(machines, placement):
            setter = getattr(m, "set_devices", None)
            if setter is not None and group:
                setter(group)
        res = CampaignResult()
        t0 = time.perf_counter()
        workers = self.max_workers or max(1, len(machines))
        # per-run cancel event and wave-execution lock (a Campaign object is
        # just config; one instance may serve concurrent run() calls). The
        # lock serializes the workers' GIL-bound fused array kernels (numpy
        # backend, scalar fallback): under the GIL, concurrently
        # interleaving them only thrashes (wave execution is the CPU-bound
        # part; plan stepping stays concurrent).  Device backends ignore it
        # for dispatch — they serialize on their own per-device-subset
        # locks instead, so the disjoint placement above actually overlaps
        cancel = threading.Event()
        execute_lock = threading.Lock()
        with obs.span("campaign.run", machines=len(machines),
                      workers=workers), \
                ThreadPoolExecutor(max_workers=workers) as pool:
            futures = {pool.submit(self._run_one, m, isa, cancel,
                                   execute_lock): m.name
                       for m in machines}
            try:
                for fut in as_completed(futures):
                    name = futures[fut]
                    # a worker failure re-raises here with the original
                    # traceback attached (concurrent.futures preserves it)
                    model, engine, dt = fut.result()
                    res.models[name] = model
                    # per-run delta (the engine may carry state from prior
                    # campaigns on the same machine), as recorded by
                    # characterize
                    res.stats[name] = dict(model.engine_stats)
                    res.phase_seconds[name] = dict(model.phase_seconds)
                    res.wave_stats[name] = dict(model.wave_stats)
                    res.uarch_seconds[name] = dt
                    if engine.stats.quarantine:
                        res.quarantine[name] = [
                            q.as_dict() for q in engine.stats.quarantine]
            except BaseException:
                # cancel the sibling workers' schedulers at their next wave
                # boundary, drop queued work, and surface the first failure
                # instead of hanging or returning a partial CampaignResult
                cancel.set()
                for f in futures:
                    f.cancel()
                raise
        res.wall_seconds = time.perf_counter() - t0
        return res
