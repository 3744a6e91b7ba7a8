"""Deterministic, seeded fault-injection plane (the chaos substrate).

A :class:`FaultPlan` is a set of :class:`FaultRule`\\ s evaluated at named
injection points threaded through the stack:

====================  ======================================================
point                 fires in
====================  ======================================================
engine.cache_io       persistent measurement-cache load/save
                      (``model_io`` / ``Campaign``)
wave.kernel           per-chunk kernel execution in ``BatchSimMachine``,
                      keyed by each code's content and tagged with the
                      executing backend — backend-restricted rules are
                      absorbed by the backend degradation chain, unkeyed
                      unrestricted ones propagate to the engine's
                      bisecting retry
wave.pack             host-side wave packing (``_pack_chunk`` callers)
device.dispatch       device-mesh kernel dispatch (``_DeviceExec``)
wire.frame            serialized wire messages — binary frame payloads and
                      JSON lines, corrupted *before* framing so length
                      headers/newlines stay consistent and decoders fail
                      typed instead of hanging
corpus.shard_write    corpus shard / per-shard result persistence
====================  ======================================================

Determinism: whether a rule fires for a given ``(point, key)`` is a pure
function of ``(seed, point, mode, key)`` — a crc32 hash mapped to
``[0, 1)`` and compared against the rule's probability.  Content-derived
keys make decisions independent of call order, retry count and wave
composition: the same poisoned experiment fails in *every* sub-wave
during bisection, which is what lets the engine converge on it.  Un-keyed
checks fall back to a per-point occurrence index (deterministic for a
fixed call sequence).  Every fired fault is recorded
(:class:`FiredFault`: point, mode, occurrence, key, seed) so any chaos
failure replays exactly from its spec.

Plans install via ``REPRO_FAULTS=<spec>`` (read once at import, like
``REPRO_TRACE``) or :func:`set_plan` in tests.  Spec grammar, clauses
joined by ``;``::

    seed=<int>
    <point>:<mode>[:p=<float>][:max=<int>][:after=<int>][:ms=<float>]
                  [:match=<substr>][:backend=<name>]

modes: ``raise`` (typed :class:`InjectedFault`), ``corrupt`` (byte
flips), ``torn`` (truncation — torn-write simulation), ``latency``
(sleep ``ms``).  Example::

    REPRO_FAULTS="seed=1337;wave.kernel:raise:p=0.02;engine.cache_io:torn"

Disabled cost: with no plan installed every hook is one module-global
load plus a ``None`` test (the same discipline as ``repro_torch.obs.tracer``'s
``NULL_SPAN`` fast path); ``bench_fault_overhead`` gates the analytic
bound at <2% of wave wall time.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from dataclasses import dataclass, field

POINTS = ("engine.cache_io", "wave.kernel", "wave.pack", "device.dispatch",
          "wire.frame", "corpus.shard_write")
MODES = ("raise", "corrupt", "torn", "latency")


class InjectedFault(RuntimeError):
    """Typed fault raised by a ``raise``-mode rule. Carries enough to
    replay: the point, the per-point occurrence index, and the content
    key (if the check was keyed)."""

    def __init__(self, point: str, mode: str = "raise",
                 occurrence: int = 0, key=None):
        msg = f"injected {mode} fault at {point} #{occurrence}"
        if key is not None:
            msg += f" (key={str(key)[:80]!r})"
        super().__init__(msg)
        self.point = point
        self.mode = mode
        self.occurrence = occurrence
        self.key = key


@dataclass
class FiredFault:
    """One recorded firing — the replay token for a chaos failure."""
    point: str
    mode: str
    occurrence: int  # per-point check index at firing time
    seed: int
    key: str | None = None

    def as_dict(self) -> dict:
        return {"point": self.point, "mode": self.mode,
                "occurrence": self.occurrence, "seed": self.seed,
                "key": self.key}


@dataclass
class FaultRule:
    """One injection rule. ``p`` is the per-decision firing probability;
    ``match`` restricts to keys containing the substring; ``backend``
    restricts ``wave.kernel``-style checks to one executing backend;
    ``max_fires`` caps total firings (0 = unlimited — a capped rule
    models a *transient* fault that a retry survives, an uncapped one a
    *persistent* fault that bisection must quarantine); ``after`` skips
    the first N eligible occurrences; ``ms`` is the latency-mode sleep."""
    point: str
    mode: str = "raise"
    p: float = 1.0
    max_fires: int = 0
    after: int = 0
    ms: float = 0.0
    match: str = ""
    backend: str = ""
    fires: int = 0  # mutable: total firings so far

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} "
                             f"(expected one of {MODES})")

    def wants(self, occurrence: int, key, backend) -> bool:
        """Static eligibility (probability decided separately)."""
        if self.max_fires and self.fires >= self.max_fires:
            return False
        if occurrence <= self.after:
            return False
        if self.backend and backend != self.backend:
            return False
        if self.match and (key is None or self.match not in str(key)):
            return False
        return True


class FaultPlan:
    """A seeded set of rules plus the record of everything that fired.

    Thread-safe: occurrence counters, fire caps and the fired-fault log
    are guarded by one lock (the plan is only consulted on the
    fault-enabled path, so the lock costs nothing when disabled)."""

    def __init__(self, rules=(), seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self.fired: list[FiredFault] = []
        self._occ: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- spec parsing --------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the ``REPRO_FAULTS`` grammar (see module docstring)."""
        seed = 0
        rules = []
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                seed = int(clause[5:])
                continue
            parts = clause.split(":")
            if len(parts) < 2:
                raise ValueError(f"fault clause {clause!r} needs "
                                 f"<point>:<mode>")
            kw: dict = {"point": parts[0], "mode": parts[1]}
            for opt in parts[2:]:
                k, sep, v = opt.partition("=")
                if not sep:
                    raise ValueError(f"fault option {opt!r} in {clause!r} "
                                     f"is not key=value")
                if k == "p":
                    kw["p"] = float(v)
                elif k == "max":
                    kw["max_fires"] = int(v)
                elif k == "after":
                    kw["after"] = int(v)
                elif k == "ms":
                    kw["ms"] = float(v)
                elif k in ("match", "backend"):
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault option {k!r} in "
                                     f"{clause!r}")
            rules.append(FaultRule(**kw))
        return cls(rules, seed=seed)

    # -- deterministic decisions ---------------------------------------------

    def _hash01(self, rule: FaultRule, token) -> float:
        payload = f"{self.seed}:{rule.point}:{rule.mode}:{token}"
        return (zlib.crc32(payload.encode()) & 0xFFFFFFFF) / 2 ** 32

    def _decide(self, rule: FaultRule, token) -> bool:
        return rule.p >= 1.0 or self._hash01(rule, token) < rule.p

    def _record(self, rule: FaultRule, occurrence: int, key) -> None:
        # caller holds self._lock
        rule.fires += 1
        self.fired.append(FiredFault(rule.point, rule.mode, occurrence,
                                     self.seed,
                                     None if key is None else str(key)))

    def occurrences(self, point: str | None = None) -> int:
        with self._lock:
            if point is not None:
                return self._occ.get(point, 0)
            return sum(self._occ.values())

    # -- injection API -------------------------------------------------------

    def check(self, point: str, key=None, backend=None) -> None:
        """Evaluate ``raise`` and ``latency`` rules at ``point``. A firing
        ``raise`` rule raises :class:`InjectedFault`; ``latency`` sleeps.
        Keyed checks decide on the key's content hash (call-order
        independent), unkeyed ones on the occurrence index."""
        sleep_ms = 0.0
        boom = None
        with self._lock:
            occ = self._occ[point] = self._occ.get(point, 0) + 1
            for rule in self.rules:
                if rule.point != point or rule.mode not in ("raise",
                                                            "latency"):
                    continue
                if not rule.wants(occ, key, backend):
                    continue
                token = key if key is not None else occ
                if not self._decide(rule, token):
                    continue
                self._record(rule, occ, key)
                if rule.mode == "latency":
                    sleep_ms += rule.ms
                elif boom is None:
                    boom = InjectedFault(point, "raise", occ, key)
        if sleep_ms:
            time.sleep(sleep_ms / 1000.0)
        if boom is not None:
            raise boom

    def check_wave(self, point: str, keys, backend=None) -> None:
        """One check covering a whole wave/chunk of content keys: raises
        if *any* key's decision fires (the wave fails as a unit — exactly
        how a poisoned experiment takes down a fused kernel). Counted as
        a single occurrence."""
        boom = None
        sleep_ms = 0.0
        with self._lock:
            occ = self._occ[point] = self._occ.get(point, 0) + 1
            for rule in self.rules:
                if rule.point != point or rule.mode not in ("raise",
                                                            "latency"):
                    continue
                for key in keys:
                    if not rule.wants(occ, key, backend):
                        continue
                    if not self._decide(rule, key):
                        continue
                    self._record(rule, occ, key)
                    if rule.mode == "latency":
                        sleep_ms += rule.ms
                    elif boom is None:
                        boom = InjectedFault(point, "raise", occ, key)
                    break  # one firing per rule per wave
        if sleep_ms:
            time.sleep(sleep_ms / 1000.0)
        if boom is not None:
            raise boom

    def filter_bytes(self, point: str, data: bytes, key=None) -> bytes:
        """Pass ``data`` through ``corrupt``/``torn`` rules at ``point``:
        corrupt flips deterministically-chosen bytes, torn truncates at a
        deterministic cut (torn-write simulation). Returns the possibly
        mangled bytes; loaders must degrade typed (ValueError /
        BinaryProtocolError), never crash or hang."""
        with self._lock:
            occ = self._occ[point] = self._occ.get(point, 0) + 1
            for rule in self.rules:
                if rule.point != point or rule.mode not in ("corrupt",
                                                            "torn"):
                    continue
                if not rule.wants(occ, key, None):
                    continue
                token = key if key is not None else occ
                if not self._decide(rule, token):
                    continue
                if not data:
                    continue
                self._record(rule, occ, key)
                h = zlib.crc32(f"{self.seed}:{point}:pos:{token}".encode())
                if rule.mode == "torn":
                    data = data[:h % len(data)]
                else:
                    buf = bytearray(data)
                    for i in range(3):
                        buf[(h + 7919 * i) % len(buf)] ^= 0xFF
                    data = bytes(buf)
        return data

    def report(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "rules": len(self.rules),
                    "checks": dict(self._occ),
                    "fired": [f.as_dict() for f in self.fired]}


# ---------------------------------------------------------------------------
# module-level plan (same fast-path discipline as repro_torch.obs.tracer._GLOBAL:
# every hook below is a global load + None test when no plan is installed)
# ---------------------------------------------------------------------------


def plan_from_env(env=None) -> FaultPlan | None:
    spec = (os.environ if env is None else env).get("REPRO_FAULTS", "")
    return FaultPlan.from_spec(spec) if spec.strip() else None


_PLAN: FaultPlan | None = plan_from_env()


def get_plan() -> FaultPlan | None:
    return _PLAN


def set_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` (or ``None`` to disable); returns the previous
    plan so tests can restore it."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    return prev


def active() -> bool:
    return _PLAN is not None


def check(point: str, key=None, backend=None) -> None:
    p = _PLAN
    if p is None:
        return
    p.check(point, key=key, backend=backend)


def check_wave(point: str, keys, backend=None) -> None:
    p = _PLAN
    if p is None:
        return
    p.check_wave(point, keys, backend=backend)


def filter_bytes(point: str, data: bytes, key=None) -> bytes:
    p = _PLAN
    if p is None:
        return data
    return p.filter_bytes(point, data, key=key)
