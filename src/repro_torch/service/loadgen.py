"""Replayable concurrent-client load generator for the serving tier.

Drives N persistent connections against a prediction server with a
pre-encoded ``predict_batch`` request (the request bytes are built once
per connection and replayed — the generator measures the *server*, not
client-side encoding). Two arrival models:

* **closed loop** (``rate_rps=None``): each connection issues its next
  request as soon as the previous response lands — measures sustained
  capacity at a given concurrency;
* **open loop** (``rate_rps=R``): requests are launched on a global
  Poisson-free fixed schedule of R per second shared across connections,
  and latency is measured from the *scheduled* arrival time, so queueing
  delay under overload is charged to the server (no coordinated
  omission). Overloaded responses (load sheds) are counted separately
  from transport errors — a saturated server that sheds quickly still
  has a healthy p99 for the requests it admits.

Results are plain dicts ready for ``experiments/benchmarks.json`` rows.
"""
from __future__ import annotations

import threading
import time


def _percentile(vals: list, q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    k = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
    return vals[k]


def run_load(host: str, port: int, uarch: str, blocks, *,
             wire: str = "auto", conns: int = 4, duration_s: float = 1.0,
             rate_rps: float | None = None, budget_us: float | None = None,
             decode: bool = False, timeout: float = 30.0) -> dict:
    """Drive the server and return an aggregate stats row.

    ``blocks`` is the wave each request carries (list of Instr lists or
    textual blocks). Returns requests/ok/shed/errors counts, achieved
    request and prediction rates, and p50/p99/max latency in ms."""
    from repro_torch.service.client import ServiceClient  # noqa: PLC0415

    n_blocks = len(blocks)
    barrier = threading.Barrier(conns + 1)
    sched_lock = threading.Lock()
    next_slot = [0]
    t0 = [0.0]
    stop_at = [0.0]
    per: list[dict] = [{"ok": 0, "shed": 0, "errors": 0, "lats": []}
                       for _ in range(conns)]

    def worker(res: dict) -> None:
        try:
            client = ServiceClient(host, port, wire=wire, timeout=timeout)
            prepared = client.prepare_batch(uarch, blocks,
                                            budget_us=budget_us)
        except Exception:  # noqa: BLE001 - setup failure counts as error
            res["errors"] += 1
            barrier.wait()
            return
        barrier.wait()
        end = stop_at[0]
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if rate_rps is not None:
                with sched_lock:
                    slot = next_slot[0]
                    next_slot[0] += 1
                sched = t0[0] + slot / rate_rps
                if sched >= end:
                    break
                delay = sched - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                lat_from = sched  # charge queueing lag to the server
            else:
                lat_from = time.perf_counter()
            try:
                ok, shed, _ = client.send_prepared(prepared, decode=decode)
            except Exception:  # noqa: BLE001 - transport failure
                res["errors"] += 1
                break
            lat = time.perf_counter() - lat_from
            if ok:
                res["ok"] += 1
                res["lats"].append(lat)
            elif shed:
                res["shed"] += 1
            else:
                res["errors"] += 1
        client.close()

    threads = [threading.Thread(target=worker, args=(per[i],), daemon=True)
               for i in range(conns)]
    for t in threads:
        t.start()
    # publish the clock BEFORE releasing the barrier: workers read
    # stop_at right after their own barrier.wait() returns
    t0[0] = time.perf_counter()
    stop_at[0] = t0[0] + duration_s
    barrier.wait()
    for t in threads:
        t.join(timeout=duration_s + 10 * timeout)
    wall = time.perf_counter() - t0[0]

    ok = sum(r["ok"] for r in per)
    shed = sum(r["shed"] for r in per)
    errors = sum(r["errors"] for r in per)
    lats = [v for r in per for v in r["lats"]]
    return {
        "wire": wire, "conns": conns, "wave": n_blocks,
        "offered_rps": rate_rps, "duration_s": round(wall, 3),
        "requests": ok + shed + errors, "ok": ok, "shed": shed,
        "errors": errors,
        "rps": round(ok / wall, 1) if wall > 0 else 0.0,
        "predictions_per_s": round(ok * n_blocks / wall, 1)
        if wall > 0 else 0.0,
        "p50_ms": round(_percentile(lats, 0.5) * 1e3, 3),
        "p99_ms": round(_percentile(lats, 0.99) * 1e3, 3),
        "max_ms": round(_percentile(lats, 1.0) * 1e3, 3),
    }
