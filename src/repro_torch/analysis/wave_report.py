"""Per-wave bottleneck attribution from an execution trace.

The port of the reference package's ``repro.analysis.wave_report``.

Consumes a trace written by :mod:`repro_torch.obs.export` (either the
Chrome trace-event JSON or the JSONL log — ``load_events`` normalizes
both) and attributes where wave time actually went:

* **stage shares** — busy µs summed per pipeline stage (lower / pack /
  kernel / dispatch / result-wait / extract / scalar / compile, plus the
  scheduler's fuse step and the engine's cache probe), as a share of all
  attributed stage time;
* **lock-wait share** — time spent *acquiring* the kernel-execute and
  dispatch locks (``wave.lock_wait`` / ``wave.dispatch_lock_wait``),
  measured separately from the work the locks guard;
* **device imbalance** — per-device busy time from the synthetic
  ``device:<id>`` kernel tracks; the imbalance ratio is max/mean busy
  (1.0 == perfectly balanced shards);
* **top-k slowest waves** — the widest/longest ``scheduler.execute``
  spans, with their wave widths.

The classification at the end names the dominant cost so a campaign run
can be read at a glance: ``kernel-bound``, ``lowering-bound``,
``lock-bound`` (lock wait above :data:`LOCK_BOUND_SHARE` of stage time),
or ``device-imbalanced`` (imbalance above :data:`IMBALANCE_BOUND`).

Usage::

    PYTHONPATH=src python scripts/analyze_torch.py --trace-report \
        run.trace.json
"""
from __future__ import annotations

from typing import Dict, List

#: span name -> report stage (order is the table's display order)
STAGE_OF = {
    "wave.lower": "lower",
    "wave.pack": "pack",
    "wave.kernel": "kernel",
    "wave.dispatch": "dispatch",
    "wave.result_wait": "result_wait",
    "wave.extract": "extract",
    "wave.scalar": "scalar",
    "wave.compile": "compile",
    "scheduler.fuse": "fuse",
    "engine.cache_probe": "cache_probe",
}

#: lock-acquisition spans, attributed separately from the guarded work
LOCK_SPANS = ("wave.lock_wait", "wave.dispatch_lock_wait")

#: lock-wait share of stage time above which the run is "lock-bound"
LOCK_BOUND_SHARE = 0.25
#: device busy max/mean ratio above which the run is "device-imbalanced"
IMBALANCE_BOUND = 1.5


def _is_device_track(ev: dict) -> bool:
    name = ev.get("tid_name") or ""
    return isinstance(name, str) and name.startswith("device:")


def wave_report(events: List[dict], top: int = 5) -> dict:
    """Aggregate a normalized event list (see
    :func:`repro_torch.obs.export.load_events`) into the attribution
    report."""
    from repro_torch.faults.tolerance import StragglerDetector  # noqa: PLC0415

    stages: Dict[str, dict] = {s: {"us": 0.0, "count": 0}
                               for s in dict.fromkeys(STAGE_OF.values())}
    lock_us = 0.0
    lock_count = 0
    devices: Dict[str, float] = {}
    straggler = StragglerDetector()
    waves: List[dict] = []
    run_batches = 0
    t_lo, t_hi = None, 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev.get("ts_us", 0.0))
        dur = float(ev.get("dur_us", 0.0))
        t_lo = ts if t_lo is None else min(t_lo, ts)
        t_hi = max(t_hi, ts + dur)
        name = ev.get("name", "")
        if _is_device_track(ev):
            # device tracks carry only kernel spans; fold into the kernel
            # stage AND the per-device busy ledger
            devices[ev["tid_name"]] = devices.get(ev["tid_name"], 0.0) + dur
            if name == "wave.kernel":
                stages["kernel"]["us"] += dur
                stages["kernel"]["count"] += 1
                # the same per-device EWMA the device executor runs live
                straggler.observe(ev["tid_name"], dur / 1e6)
            continue
        if name in LOCK_SPANS:
            lock_us += dur
            lock_count += 1
            continue
        stage = STAGE_OF.get(name)
        if stage is not None:
            stages[stage]["us"] += dur
            stages[stage]["count"] += 1
        elif name == "wave.run_batch":
            run_batches += 1
        elif name == "scheduler.execute":
            args = ev.get("args", {}) or {}
            waves.append({"ts_us": ts, "dur_us": dur,
                          "wave": args.get("wave"),
                          "plans": args.get("plans")})
    stage_us = sum(s["us"] for s in stages.values())
    denom = stage_us + lock_us
    for s in stages.values():
        s["share"] = s["us"] / denom if denom else 0.0
    lock_share = lock_us / denom if denom else 0.0
    busy = sorted(devices.values())
    imbalance = (busy[-1] / (sum(busy) / len(busy))
                 if busy and sum(busy) else 0.0)
    waves.sort(key=lambda w: -w["dur_us"])
    bottleneck = _classify(stages, lock_share, imbalance)
    return {
        "wall_us": (t_hi - t_lo) if t_lo is not None else 0.0,
        "stage_us": stage_us,
        "stages": stages,
        "lock_wait": {"us": lock_us, "count": lock_count,
                      "share": lock_share},
        "devices": devices,
        "device_imbalance": imbalance,
        "stragglers": straggler.snapshot(),
        "waves": run_batches,
        "top_waves": waves[:top],
        "bottleneck": bottleneck,
    }


def _classify(stages: dict, lock_share: float, imbalance: float) -> str:
    if lock_share >= LOCK_BOUND_SHARE:
        return "lock-bound"
    if imbalance >= IMBALANCE_BOUND:
        return "device-imbalanced"
    best, best_us = "idle", 0.0
    for name, s in stages.items():
        if s["us"] > best_us:
            best, best_us = name, s["us"]
    if best == "idle":
        return "idle"
    if best in ("lower", "compile"):
        return "lowering-bound"
    return f"{best}-bound"


def format_wave_report(rep: dict) -> str:
    """Render the report as the CLI's fixed-width table."""
    lines = [
        f"trace: {rep['wall_us'] / 1e3:.1f} ms wall, "
        f"{rep['waves']} wave(s), bottleneck: {rep['bottleneck']}",
        "",
        f"{'stage':<12} {'time ms':>10} {'share':>7} {'spans':>7}",
    ]
    rows = sorted(rep["stages"].items(), key=lambda kv: -kv[1]["us"])
    for name, s in rows:
        if not s["count"]:
            continue
        lines.append(f"{name:<12} {s['us'] / 1e3:>10.2f} "
                     f"{s['share'] * 100:>6.1f}% {s['count']:>7}")
    lw = rep["lock_wait"]
    lines.append(f"{'lock_wait':<12} {lw['us'] / 1e3:>10.2f} "
                 f"{lw['share'] * 100:>6.1f}% {lw['count']:>7}")
    if rep["devices"]:
        lines.append("")
        lines.append(f"device busy (imbalance "
                     f"{rep['device_imbalance']:.2f}x max/mean):")
        for dev, us in sorted(rep["devices"].items()):
            lines.append(f"  {dev:<12} {us / 1e3:>10.2f} ms")
        flagged = (rep.get("stragglers") or {}).get("flagged") or []
        if flagged:
            st = rep["stragglers"]
            lines.append(f"stragglers (EWMA > {2.0:.1f}x fleet median "
                         f"{st['median_s'] * 1e3:.2f} ms):")
            for dev in flagged:
                lines.append(f"  {dev:<12} "
                             f"{st['ewma_s'][dev] * 1e3:>10.2f} ms EWMA")
    if rep["top_waves"]:
        lines.append("")
        lines.append(f"slowest waves (top {len(rep['top_waves'])}):")
        for w in rep["top_waves"]:
            lines.append(f"  t={w['ts_us'] / 1e3:>9.2f} ms "
                         f"dur={w['dur_us'] / 1e3:>8.2f} ms "
                         f"wave={w['wave']} plans={w['plans']}")
    return "\n".join(lines)


def report_from_file(path, top: int = 5) -> dict:
    """Load a trace file (either exporter format) and build the report."""
    from repro_torch.obs.export import load_events  # noqa: PLC0415

    return wave_report(load_events(path), top=top)
