"""Fault-tolerance policies: straggler detection, heartbeats,
restart/elastic decisions.

A copy of the reference package's ``repro.faults.tolerance``. The
:class:`StragglerDetector` EWMA is fed by ``BatchSimMachine``'s device
executor with per-device kernel wall times (see ``device_stats()``).
The *decisions* (restart from
checkpoint, drop to a smaller mesh, flag stragglers) are pure functions
so they are testable without hardware.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    """Per-step wall-time EWMA + robust outlier flagging.

    A worker (a device in the mesh, or the single local process's step
    time) is a straggler when its step time exceeds ``threshold`` × the
    fleet median EWMA.
    """
    alpha: float = 0.2
    threshold: float = 2.0
    ewma: dict = field(default_factory=dict)  # worker -> ewma seconds

    def observe(self, worker: str, step_seconds: float) -> None:
        prev = self.ewma.get(worker)
        self.ewma[worker] = (step_seconds if prev is None
                             else (1 - self.alpha) * prev
                             + self.alpha * step_seconds)

    def median(self) -> float:
        vals = sorted(self.ewma.values())
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> list[str]:
        med = self.median()
        if med <= 0:
            return []
        return [w for w, v in self.ewma.items() if v > self.threshold * med]

    def snapshot(self) -> dict:
        """Flagging state for telemetry (``device_stats()`` / reports)."""
        med = self.median()
        return {"median_s": med,
                "ewma_s": {w: v for w, v in sorted(self.ewma.items())},
                "flagged": sorted(self.stragglers())}


@dataclass
class FleetMonitor:
    """Heartbeat bookkeeping + restart/elastic decisions."""
    heartbeat_timeout: float = 60.0
    last_seen: dict = field(default_factory=dict)
    now_fn: callable = time.monotonic

    def heartbeat(self, worker: str, t: float | None = None) -> None:
        self.last_seen[worker] = self.now_fn() if t is None else t

    def dead_workers(self) -> list[str]:
        now = self.now_fn()
        return [w for w, t in self.last_seen.items()
                if now - t > self.heartbeat_timeout]

    def plan(self, total_workers: int, min_workers: int) -> dict:
        """Decide: continue / restart_same / restart_elastic / halt.

        restart_same: dead workers expected back (spare capacity) — restore
        the latest checkpoint on the same mesh. restart_elastic: shrink the
        data-parallel axis to the largest feasible power-of-two and reshard
        (checkpoint.restore_checkpoint supports N->M). halt: below quorum.
        """
        dead = self.dead_workers()
        alive = total_workers - len(dead)
        if not dead:
            return {"action": "continue", "dead": []}
        if alive < min_workers:
            return {"action": "halt", "dead": dead}
        target = 1 << (alive.bit_length() - 1)  # largest power of two <= alive
        if target == total_workers:
            return {"action": "restart_same", "dead": dead}
        return {"action": "restart_elastic", "dead": dead,
                "new_data_parallel": target}


@dataclass
class StepTimer:
    """Context helper that feeds the detector one timed step."""
    detector: StragglerDetector
    worker: str = "local"
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.detector.observe(self.worker, time.perf_counter() - self._t0)
        return False
