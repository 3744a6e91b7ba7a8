"""Kernel-level unit-occupancy attribution via blocking kernels.

The port of the reference package's ``repro/core/kernel_bench.py``: the
counter-free variant of Algorithm 1, one level up.  On a card without
per-unit counters, run the target kernel K beside each blocking kernel B_u
(``kernels/microbench.py`` saturates one unit each) and classify from the
contention signature

    overlap(K, B_u) = (t(K) + t(B_u) - t(K ‖ B_u)) / min(t(K), t(B_u))

≈ 1: K and B_u use *different* units (their execution overlaps fully);
≈ 0: same unit (serialized — the unit is the contended resource).

``t(K ‖ B_u)`` runs K on the current stream and B_u on a side stream that
first waits for the current one; the current stream then waits for the
side stream, and the clock stops after the device has finished both.  On
the CPU the two run one after the other, so every overlap is ≈ 0 there.
Each time is the best of ``reps`` calls after one warm-up call, read on the
host clock, so it includes the launch overhead of the calls.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core.device_mesh import resolve_device
from repro_torch.core.hardware import synchronize


@dataclass
class KernelProfile:
    name: str
    alone_ns: float
    overlap: dict = field(default_factory=dict)  # unit -> coefficient

    def likely_units(self, threshold: float = 0.5) -> list[str]:
        return [u for u, c in self.overlap.items() if c < threshold]


def _time(f, device, reps: int = 5) -> float:
    f()
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        f()
        synchronize(device)
        best = min(best, time.perf_counter_ns() - t0)
    return best


def _side_by_side(target_fn, blk, device):
    """``target_fn`` and ``blk`` run at once: the target on the current
    stream, the blocker on a side stream (the CPU runs them in turn)."""
    if device.type != "cuda":
        def both():
            return target_fn(), blk()

        return both
    side = torch.cuda.Stream(device)

    def both():
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        k = target_fn()
        with torch.cuda.stream(side):
            b = blk()
        main.wait_stream(side)
        return k, b

    return both


def profile_kernel(name: str, target_fn, blockers: dict, *,
                   device=None) -> KernelProfile:
    """target_fn and each blocker: nullary callables returning tensors on
    ``device`` (default ``cuda:0``)."""
    dev = resolve_device(device)
    t_k = _time(target_fn, dev)
    prof = KernelProfile(name, t_k)
    for unit, blk in blockers.items():
        t_b = _time(blk, dev)
        t_kb = _time(_side_by_side(target_fn, blk, dev), dev)
        denom = min(t_k, t_b)
        prof.overlap[unit] = ((t_k + t_b - t_kb) / denom) if denom else 0.0
    return prof
