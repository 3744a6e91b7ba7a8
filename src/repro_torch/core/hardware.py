"""Wall-clock measurement backend for real PyTorch ops.

The port of the reference package's ``repro/core/hardware.py``: the
paper's hardware-measurement path applied to the op granularity that
exists on the card.  Per-port μop counters do not exist here (they are
simulator-only), so this backend produces *latency* (dependent-chain) and
*throughput* (independent-lanes) tables — the situation the paper faces on
microarchitectures IACA does not support.

Protocol = Algorithm 2 adapted to wall clock: one warm-up call, then the
best of ``reps`` calls, each between one pair of ``time.perf_counter_ns``
readings and ended by ``torch.cuda.synchronize`` on the card.  Chains of
``n_small`` and ``n_large`` applications are timed and differenced, which
cancels the fixed cost of a call the way the serializing-instruction
overhead is cancelled on x86.

What an eager chain measures: the reference jits the whole chain into one
program; here each application runs eagerly, so a per-op time on the card
includes PyTorch's dispatch and launch overhead for every kernel the op
issues — what an eager caller pays.  Differencing cancels only the fixed
part of that overhead (the call and the synchronize), not the per-op part.
The lanes variant applies ``torch.func.vmap(f)`` to ``lanes`` stacked
copies of the example.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.core.device_mesh import resolve_device


@dataclass
class OpMeasurement:
    name: str
    latency_ns: float      # dependent-chain ns/op
    throughput_ns: float   # independent-lanes ns/op
    flops: float = 0.0     # per application (analytic, from the corpus)

    @property
    def achieved_gflops(self) -> float:
        return (self.flops / self.throughput_ns) if self.throughput_ns else 0.0


def synchronize(device) -> None:
    """Wait for the device's queued work: ``torch.cuda.synchronize`` on a
    card, nothing on the CPU (its ops have finished when they return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_callable(f, *args, device, reps: int = 5) -> float:
    f(*args)  # warm-up (lazy module loads, allocator, caches)
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        f(*args)
        synchronize(device)
        best = min(best, time.perf_counter_ns() - t0)
    return best


def _chain(f, n: int):
    def run(x):
        for _ in range(n):
            x = f(x)
        return x

    return run


def _lanes(f, n: int, lanes: int):
    vf = torch.func.vmap(f)

    def run(x):
        for _ in range(n):
            x = vf(x)
        return x

    return run


def measure_op(name: str, f, example, *, n_small: int = 8, n_large: int = 72,
               lanes: int = 8, flops: float = 0.0,
               device=None) -> OpMeasurement:
    """f must be shape-preserving (chainable): f(x) -> x-like.  Runs on
    ``device`` (default ``cuda:0``); the example is moved there."""
    dev = resolve_device(device)
    example = example.to(dev)
    t1 = _time_callable(_chain(f, n_small), example, device=dev)
    t2 = _time_callable(_chain(f, n_large), example, device=dev)
    lat = max((t2 - t1) / (n_large - n_small), 0.0)
    xs = torch.stack([example] * lanes)
    t1 = _time_callable(_lanes(f, n_small, lanes), xs, device=dev)
    t2 = _time_callable(_lanes(f, n_large, lanes), xs, device=dev)
    tput = max((t2 - t1) / ((n_large - n_small) * lanes), 0.0)
    return OpMeasurement(name, lat, tput, flops)


def characterize_corpus(corpus: dict, **kw) -> dict[str, OpMeasurement]:
    """corpus: name -> (fn, example, flops)."""
    out = {}
    for name, (f, example, flops) in corpus.items():
        out[name] = measure_op(name, f, example, flops=flops, **kw)
    return out
