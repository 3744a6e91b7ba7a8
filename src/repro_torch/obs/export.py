"""Trace exporters: Chrome trace-event JSON and a compact JSONL log.

The port of the reference package's ``repro.obs.export``: the same
functions and formats, over the port's tracer.

``chrome_trace`` renders a :class:`repro_torch.obs.tracer.Tracer`'s events
into the `trace-event format`__ understood by Perfetto and
``chrome://tracing``:

* one track per real thread (named after ``threading.Thread.name``),
* one synthetic track per named track (``device:0`` … — per-device kernel
  timelines),
* counter tracks (``ph == "C"``) for sampled values such as cache
  hit-rate and wave width.

__ https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU

Timestamps are µs relative to the tracer's start (monotonic clock), which
is what the viewers expect; ``chrome_trace(epoch=True)`` gives µs since
the Unix epoch instead, through the tracer's ``t0_epoch_ns`` anchor: the
clock of ``torch.profiler``'s events, so the spans can be laid into a
profiler trace of the same run (``bench/spans.py --export``).
``write_jsonl`` dumps the raw internal events
one-JSON-object-per-line for cheap ad-hoc grepping; ``load_events``
re-reads either format for :mod:`repro_torch.analysis.wave_report`.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.tracer import Tracer, get_tracer

#: synthetic tid range for named tracks, far above real thread idents' use
#: as display sort keys once remapped
_TRACK_TID_BASE = 1 << 20


def _tid_map(tracer: Tracer) -> Dict[object, int]:
    """Stable mapping from event tid keys (thread idents and track names)
    to small integer tids for the viewer."""
    mapping: Dict[object, int] = {}
    for i, ident in enumerate(sorted(tracer.thread_names()), start=1):
        mapping[ident] = i
    for j, track in enumerate(sorted(tracer.tracks())):
        mapping[track] = _TRACK_TID_BASE + j
    return mapping


def chrome_trace(tracer: Optional[Tracer] = None, *,
                 process_name: str = "repro", epoch: bool = False) -> dict:
    """Render the tracer's events as a trace-event JSON object."""
    tr = tracer if tracer is not None else get_tracer()
    tids = _tid_map(tr)
    pid = tr.pid
    # the tracer-clock time exported timestamps count from: the tracer's
    # start, or the Unix epoch through its anchor
    t0 = tr.t0_ns - (tr.t0_epoch_ns if epoch else 0)
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": process_name}},
    ]
    for ident, name in sorted(tr.thread_names().items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tids[ident], "args": {"name": name}})
    for track in sorted(tr.tracks()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tids[track], "args": {"name": track}})
    for ev in tr.events():
        tid = tids.get(ev["tid"], 0)
        ts = (ev["t0"] - t0) / 1000.0
        out = {"ph": ev["ph"], "name": ev["name"], "pid": pid, "tid": tid,
               "ts": ts, "args": ev["args"] or {}}
        if ev["ph"] == "X":
            out["dur"] = ev["dur"] / 1000.0
        elif ev["ph"] == "i":
            out["s"] = "t"  # thread-scoped instant
        events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, tracer: Optional[Tracer] = None, *,
                       process_name: str = "repro") -> str:
    """Write the Perfetto-loadable JSON; returns the path written."""
    doc = chrome_trace(tracer, process_name=process_name)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return str(path)


def write_jsonl(path, tracer: Optional[Tracer] = None) -> str:
    """Write the raw events as one JSON object per line."""
    tr = tracer if tracer is not None else get_tracer()
    t0 = tr.t0_ns
    with open(path, "w") as fh:
        for ev in tr.events():
            rec = {"ph": ev["ph"], "name": ev["name"],
                   "ts_us": (ev["t0"] - t0) / 1000.0,
                   "dur_us": ev["dur"] / 1000.0,
                   "tid": ev["tid"] if isinstance(ev["tid"], str)
                   else int(ev["tid"]),
                   "args": ev["args"] or {}}
            fh.write(json.dumps(rec) + "\n")
    return str(path)


def load_events(path) -> List[dict]:
    """Load events from either exporter's output into one normalized
    shape: ``{"ph", "name", "ts_us", "dur_us", "tid", "tid_name", "args"}``.

    For Chrome-trace files the thread_name metadata is folded into
    ``tid_name`` so reports can tell device tracks from worker threads."""
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None  # one JSON object per line -> the JSONL log
    if isinstance(doc, dict):
        raw = doc.get("traceEvents", [])
        names = {ev["tid"]: ev["args"].get("name", "")
                 for ev in raw
                 if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
        out = []
        for ev in raw:
            if ev.get("ph") == "M":
                continue
            out.append({"ph": ev["ph"], "name": ev["name"],
                        "ts_us": ev.get("ts", 0.0),
                        "dur_us": ev.get("dur", 0.0),
                        "tid": ev.get("tid", 0),
                        "tid_name": names.get(ev.get("tid"), ""),
                        "args": ev.get("args", {})})
        return out
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        tid = rec.get("tid", 0)
        rec.setdefault("tid_name", tid if isinstance(tid, str) else "")
        out.append(rec)
    return out
