"""Counter/gauge/histogram registry with one canonical ``snapshot()`` shape.

Before this module, each layer reported through its own ad-hoc dict with
its own naming convention: ``EngineStats.as_dict()`` (flat snake_case),
``BatchSimMachine.device_stats()`` (nested per-device), and the server's
per-endpoint reservoirs (``p50_us``/``p99_us``).  Those legacy shapes are
kept — benches and clients pin them — but each is now *derived from* a
:class:`MetricsRegistry`: the absorb helpers below map every legacy key to
a canonical dotted instrument name, and the legacy dicts are reconstructed
from the registry snapshot through the documented alias tables.

Canonical snapshot shape (``MetricsRegistry.snapshot()``)::

    {
      "engine.cache.hits":        {"type": "counter", "value": 42},
      "device.mesh.width":        {"type": "gauge",   "value": 4},
      "server.endpoint.predict":  {"type": "histogram", "count": 9,
                                   "sum": ..., "min": ..., "max": ...,
                                   "p50": ..., "p99": ...},
      ...
    }

Instruments are cheap, lock-protected, and dependency-free; histograms
keep a bounded sample reservoir (newest ``keep`` observations) plus exact
count/sum/min/max.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Last-written value (may be any JSON-serialisable scalar)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._v = v

    def add(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """Bounded-reservoir distribution: exact count/sum/min/max, quantiles
    over the newest ``keep`` observations (the same recent-window
    semantics the server's endpoint reservoirs always had)."""

    __slots__ = ("name", "keep", "_vals", "_i", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, keep: int = 2048):
        self.name = name
        self.keep = keep
        self._vals: List[float] = []
        self._i = 0
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._vals) < self.keep:
                self._vals.append(v)
            else:  # ring overwrite: keep the newest `keep` samples
                self._vals[self._i] = v
                self._i = (self._i + 1) % self.keep

    def observe_many(self, v: float, n: int):
        """n observations of the same value under one lock acquisition —
        the batched-endpoint hot path (a 512-block wave is one call, not
        512 lock round-trips)."""
        if n <= 0:
            return
        with self._lock:
            self._count += n
            self._sum += v * n
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            room = self.keep - len(self._vals)
            fill = min(n, room)
            if fill > 0:
                self._vals.extend([v] * fill)
                n -= fill
            for _ in range(min(n, self.keep)):  # ring overwrite
                self._vals[self._i] = v
                self._i = (self._i + 1) % self.keep

    @property
    def count(self):
        return self._count

    def quantile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._vals)
        if not vals:
            return 0.0
        k = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
        return vals[k]

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._vals)
            out = {"type": "histogram", "count": self._count,
                   "sum": self._sum,
                   "min": self._min if self._min is not None else 0.0,
                   "max": self._max if self._max is not None else 0.0}
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            if vals:
                k = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
                out[key] = vals[k]
            else:
                out[key] = 0.0
        return out


class MetricsRegistry:
    """Get-or-create instrument registry; the single snapshot surface."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inst: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._inst.get(name)
            if inst is None:
                inst = self._inst[name] = cls(name, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(f"instrument {name!r} already registered "
                                f"as {type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, keep: int = 2048) -> Histogram:
        return self._get(name, Histogram, keep=keep)

    def set_gauges(self, mapping: Dict[str, Any], prefix: str = ""):
        """Bulk-register a flat dict of scalars as gauges."""
        for k, v in mapping.items():
            self.gauge(prefix + k).set(v)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._inst)

    def get(self, name: str):
        with self._lock:
            return self._inst.get(name)

    def value(self, name: str):
        inst = self.get(name)
        return None if inst is None else inst.snapshot().get("value")

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._inst.items())
        return {name: inst.snapshot() for name, inst in sorted(items)}


# ----------------------------------------------------------------------
# Legacy-shape adapters.  Each table maps `legacy key -> canonical
# instrument name`; the legacy dicts the rest of the repo exposes are
# reconstructed from a registry through these tables, so the registry is
# the single source of truth and the old keys are documented aliases.

#: ``EngineStats.as_dict()`` aliases (see :class:`repro_torch.core.engine.EngineStats`)
ENGINE_ALIASES: Dict[str, str] = {
    "requests": "engine.requests",
    "cache_hits": "engine.cache.hits",
    "dedup_hits": "engine.cache.dedup_hits",
    "executions": "engine.executions",
    "machine_runs": "engine.machine_runs",
    "batches": "engine.batches",
    "evictions": "engine.cache.evictions",
    "lowering_hits": "engine.lowering.hits",
    "lowering_misses": "engine.lowering.misses",
    "lowering_evictions": "engine.lowering.evictions",
    "quarantined": "engine.quarantined",
    "bisect_retries": "engine.bisect_retries",
    "degraded_chunks": "engine.degraded_chunks",
    "hit_rate": "engine.cache.hit_rate",
}

#: top-level numeric keys of ``BatchSimMachine.device_stats()``
DEVICE_ALIASES: Dict[str, str] = {
    "compiles": "device.compiles",
    "kernel_calls": "device.kernel_calls",
    "mesh": "device.mesh.width",
    "devices": "device.count",
}

#: keys of each per-endpoint summary in ``PredictionService.stats()``
ENDPOINT_ALIASES: Dict[str, str] = {
    "requests": "count",
    "errors": "errors",
    "p50_us": "p50",
    "p99_us": "p99",
}


def absorb_device_stats(reg: MetricsRegistry, dstats: Dict[str, Any],
                        prefix: str = "") -> MetricsRegistry:
    """Register a ``device_stats()``-shaped dict as instruments.

    Structural fields (``backend``, ``buckets``) become gauges holding the
    value verbatim; per-device counters land under
    ``device.<id>.<field>``."""
    for legacy, name in DEVICE_ALIASES.items():
        if legacy in dstats:
            reg.gauge(prefix + name).set(dstats[legacy])
    if "backend" in dstats:
        reg.gauge(prefix + "device.backend").set(dstats["backend"])
    if "buckets" in dstats:
        reg.gauge(prefix + "device.buckets").set(dstats["buckets"])
    for did, per in (dstats.get("per_device") or {}).items():
        base = f"{prefix}device.{did}."
        for k, v in per.items():
            reg.gauge(base + k).set(v)
    return reg


def absorb_server_stats(reg: MetricsRegistry, stats: Dict[str, Any],
                        prefix: str = "server.") -> MetricsRegistry:
    """Register a ``PredictionService.stats()``-shaped dict as instruments."""
    if "uptime_s" in stats:
        reg.gauge(prefix + "uptime_s").set(stats["uptime_s"])
    for ep, summ in (stats.get("endpoints") or {}).items():
        base = f"{prefix}endpoint.{ep}."
        for legacy, name in ENDPOINT_ALIASES.items():
            if legacy in summ:
                reg.gauge(base + name).set(summ[legacy])
    for section in ("cache", "coalescer", "registry", "admission", "wire",
                    "wave_cache", "predictor"):
        sub = stats.get(section)
        if isinstance(sub, dict):
            for k, v in sub.items():
                if isinstance(v, (int, float, bool)):
                    reg.gauge(f"{prefix}{section}.{k}").set(v)
    # per-shard cache hit rates (sharded result cache front door)
    for i, sh in enumerate((stats.get("cache") or {}).get("shards") or ()):
        for k, v in sh.items():
            if isinstance(v, (int, float, bool)):
                reg.gauge(f"{prefix}cache.shard.{i}.{k}").set(v)
    return reg


def legacy_engine_dict(reg: MetricsRegistry,
                       order: Iterable[str] = ENGINE_ALIASES) -> dict:
    """Reconstruct the legacy ``EngineStats.as_dict()`` shape from a
    registry populated with the canonical ``engine.*`` instruments."""
    return {legacy: reg.value(ENGINE_ALIASES[legacy]) for legacy in order}
