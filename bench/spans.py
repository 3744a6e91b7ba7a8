"""Device time by program span: the traced sub-window's kernels, copies and
fills, each given to the program span (``repro_torch.obs``) that launched
it and to a phase of the work.

While the program's tracer is on under ``torch.profiler``, each span is a
``record_function`` range, a user annotation in the profiler's trace, on
the thread that entered it.  The annotations' own device events
(``gpu_user_annotation``) are not device work and are left out of the busy
union and the kernel count.  Every other device event goes:

* through its launching host event (the CPU operator, by the device
  event's ``linked_correlation_id``; else the runtime call, by its
  ``correlation_id``) to the innermost span open on that thread at the
  launch: phase ``recompute`` where that span lies inside a
  ``train.backward`` span (activation checkpointing runs the layer bodies
  again there), ``backward`` where it is ``train.backward`` itself,
  ``forward`` otherwise;
* where the launch lies inside an autograd node (a host event with a
  ``sequence_nr`` and a ``fwd_thread_id``) before any span, through the
  node's ``sequence_nr`` and ``fwd_thread_id`` to the forward operator
  that recorded it, and from there to that operator's span: phase
  ``backward``;
* where its thread has no span open, to the innermost span open on any
  thread (the autograd engine's own work inside ``train.backward``);
* else to ``(no span)``.

``split`` and ``attribute`` take the events as ``bench/trace.py``'s
``profile`` has them, the device's and the host's, and add only what
spans give; the busy union and the kernel count stay ``bench/trace.py``'s.
The benchmark's run (``bench/run.py``) does not turn the program's tracer
on, so its traced runs carry no annotation.  This module's own command
times one cell's units with the tracer off and on (off, on, on, off),
then profiles them the same way, and prints the table of spans and the
readings the span metrics of ``METRICS`` would give; ``--export`` writes
the first traced profile's kernels and spans as one Chrome trace:

    python3 bench/spans.py --workload NAME --seed N [--units K] [--export PATH]

Standard output's last line is a JSON object; the table goes to standard
error.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PHASES = ("forward", "recompute", "backward")
NO_SPAN = "(no span)"
BACKWARD = "train.backward"

#: a span metric: the spans and phases whose device time it sums, in ms a
#: unit of the traced sub-window (``None``: every span)
METRICS = {
    "ssd_ms.prefill": (("mamba.ssd",), PHASES),
    "ssd_ms.train": (("mamba.ssd",), PHASES),
    "proj_ms.prefill": (("mamba.proj", "mamba.out"), PHASES),
    "proj_ms.train": (("mamba.proj", "mamba.out"), PHASES),
    "adamw_ms.train": (("optim.adamw",), PHASES),
    "recompute_ms.train": (None, ("recompute",)),
}


def _is_runtime(e) -> bool:
    """A host event that is a runtime or driver call; in releases without
    ``activity_type`` (torch 2.11) told by its name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at() in ("cuda_runtime", "cuda_driver")
    return e.name().startswith("cu")


def split(events):
    """The profiler's events as (device work, host events, the
    annotations' device shadows counted by name): the shadows are no
    device work, and are kept out of the busy union and the kernel
    count."""
    from torch.autograd import DeviceType

    from bench import trace as TR
    dev, host, shadows = [], [], Counter()
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host.append(e)
        elif (e.is_user_annotation()
              or TR._activity(e) == "gpu_user_annotation"):
            shadows[e.name()] += 1
        else:
            dev.append(e)
    return dev, host, shadows


class _Mark:
    """A span (``node`` None) or an autograd node's backward (``node``:
    the (sequence_nr, forward thread) of the op that recorded it)."""

    __slots__ = ("start", "end", "name", "span", "node")

    def __init__(self, start, end, name, node=None):
        self.start, self.end, self.name = start, end, name
        self.span, self.node = node is None, node


class Host:
    """The host side of a trace: the spans (annotations), the autograd
    nodes and the operators, by thread; answers 'which span, which phase'
    for launches at (time, thread)."""

    def __init__(self, host_events):
        self.marks = defaultdict(list)      # tid -> spans and nodes
        self.forward_op = {}                # (sequence_nr, tid) -> start, tid
        self.spans = []                     # every span, by start
        self.calls = defaultdict(int)
        for e in host_events:
            s = e.start_ns()
            end = s + e.duration_ns()
            tid = e.start_thread_id()
            if e.is_user_annotation():
                m = _Mark(s, end, e.name())
                self.marks[tid].append(m)
                self.spans.append(m)
                self.calls[e.name()] += 1
                continue
            seq = e.sequence_nr()
            if seq < 0:
                continue
            fwd = e.fwd_thread_id()
            if fwd > 0:                     # an autograd node's backward
                self.marks[tid].append(_Mark(s, end, e.name(), (seq, fwd)))
            else:                           # the op that records node seq
                key = (seq, tid)
                if key not in self.forward_op or s < self.forward_op[key][0]:
                    self.forward_op[key] = (s, tid)
        for ms in self.marks.values():
            ms.sort(key=lambda m: (m.start, -m.end))
        self.spans.sort(key=lambda m: (m.start, -m.end))
        self._starts = [m.start for m in self.spans]
        self._backward = [(m.start, m.end) for m in self.spans
                          if m.name == BACKWARD]

    def phase(self, m: _Mark) -> str:
        if m.name == BACKWARD:
            return "backward"
        if any(s <= m.start and m.end <= e for s, e in self._backward):
            return "recompute"
        return "forward"

    def _any_thread(self, t: int):
        """The innermost span open at ``t`` on any thread."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, -1, -1):
            if self.spans[j].end > t:
                return self.spans[j]
        return None

    def _stacks(self, queries):
        """For each (t, tid) the enclosing marks on ``tid``, innermost
        first: a sweep a thread with a stack of open marks."""
        out = [()] * len(queries)
        by_tid = defaultdict(list)
        for i, (t, tid) in enumerate(queries):
            if tid is not None:
                by_tid[tid].append((t, i))
        for tid, qs in by_tid.items():
            qs.sort()
            marks, k, stack = self.marks.get(tid, []), 0, []
            for t, i in qs:
                while k < len(marks) and marks[k].start <= t:
                    m = marks[k]
                    while stack and stack[-1].end <= m.start:
                        stack.pop()
                    stack.append(m)
                    k += 1
                while stack and stack[-1].end <= t:
                    stack.pop()
                out[i] = tuple(m for m in reversed(stack)
                               if m.start <= t < m.end)
        return out

    def resolve(self, queries):
        """(span name, phase) for each launch (t, tid); ``tid`` None for a
        launch known only by its time."""
        res = [None] * len(queries)
        via_node = []                       # (query index, forward op)
        for i, stack in enumerate(self._stacks(queries)):
            m = next((m for m in stack
                      if m.span or m.node in self.forward_op), None)
            if m is None:
                m = self._any_thread(queries[i][0])
            if m is None:
                res[i] = (NO_SPAN, "forward")
            elif m.span:
                res[i] = (m.name, self.phase(m))
            else:
                via_node.append((i, self.forward_op[m.node]))
        fwd = self._stacks([op for _, op in via_node])
        for (i, op), stack in zip(via_node, fwd):
            m = next((m for m in stack if m.span), None)
            if m is None:
                m = self._any_thread(op[0])
            res[i] = (m.name if m is not None else NO_SPAN, "backward")
        return res


def attribute(dev, host, busy) -> dict:
    """Device work ``dev`` (the annotations' shadows already out:
    ``split``) given to the spans of the host events ``host``:
    ``{"spans": {name: {phase: s, "kernels": {phase: n}, "calls"}},
    "attributed_s", "idle_by_span"}``, the last the device's idle time
    (outside ``busy``, the union of ``dev``, within the host's first and
    last event) summed by the innermost span open at each gap's midpoint
    on any thread."""
    from bench import trace as TR

    ops, runtime = {}, {}
    for e in host:
        (runtime if _is_runtime(e) else ops)[e.correlation_id()] = e
    queries = []
    for e in dev:
        op = ops.get(e.linked_correlation_id())
        if op is not None:
            queries.append((op.start_ns(), op.start_thread_id()))
        else:
            rt = runtime.get(e.correlation_id())
            queries.append((rt.start_ns(), None) if rt is not None
                           else (None, None))
    h = Host(host)
    found = iter(h.resolve([q for q in queries if q[0] is not None]))
    spans = defaultdict(lambda: {**dict.fromkeys(PHASES, 0.0),
                                 "kernels": dict.fromkeys(PHASES, 0),
                                 "calls": 0})
    spans[NO_SPAN] = spans.default_factory()     # always reported
    for e, q in zip(dev, queries):
        name, phase = next(found) if q[0] is not None else (NO_SPAN,
                                                              "forward")
        row = spans[name]
        row[phase] += e.duration_ns() / 1e9
        row["kernels"][phase] += int(TR._activity(e) == "kernel")
    for name, n in h.calls.items():
        spans[name]["calls"] = n
    attributed = sum(sum(r[p] for p in PHASES)
                     for n, r in spans.items() if n != NO_SPAN)
    idle = defaultdict(float)
    if busy and host:
        w0 = min(e.start_ns() for e in host)
        w1 = max(e.start_ns() + e.duration_ns() for e in host)
        edges = ([(w0, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                       for i in range(len(busy) - 1)]
                 + [(busy[-1][1], w1)])
        for s, e in edges:
            if e > s:
                m = h._any_thread((s + e) // 2)
                idle[m.name if m else NO_SPAN] += (e - s) / 1e9
    return {"spans": {k: dict(v) for k, v in spans.items()},
            "attributed_s": attributed,
            "idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1])}


def metric(name: str, att: dict | None, units: int):
    """Span metric ``name`` (``METRICS``) in device ms a unit, or None
    where the trace has no span or no device time (a CPU run)."""
    spans = (att or {}).get("spans", {})
    if not any(n != NO_SPAN and r["calls"] for n, r in spans.items()) or \
            not any(r[p] for r in spans.values() for p in PHASES):
        return None
    which, phases = METRICS[name]
    rows = [r for n, r in spans.items()
            if n != NO_SPAN and (which is None or n in which)]
    return 1000 * sum(r[p] for r in rows for p in phases) / units


def table(att: dict, busy_s: float, units: int) -> list:
    """The spans as lines: device ms and kernels a unit by phase, calls a
    unit, busiest first; ``(no span)`` last."""
    rows = sorted(att["spans"].items(),
                  key=lambda kv: (kv[0] == NO_SPAN,
                                  -sum(kv[1][p] for p in PHASES)))
    out = [f"{'span':<16}" + "".join(f"{p:>12}" for p in PHASES) +
           "".join(f"{'k.' + p[:3]:>10}" for p in PHASES) +
           f"{'calls':>8}   (device ms, kernels, calls: a unit of {units})"]
    for name, r in rows:
        out.append(f"{name:<16}" + "".join(
            f"{1000 * r[p] / units:>12.3f}" for p in PHASES) + "".join(
            f"{r['kernels'][p] / units:>10.1f}" for p in PHASES) +
            f"{r['calls'] / units:>8.1f}")
    share = att["attributed_s"] / busy_s if busy_s else 0.0
    out.append(f"attributed to a span: {100 * share:.2f}% of "
               f"{1000 * busy_s / units:.3f} busy ms a unit")
    out.append("idle ms a unit by span: " + ", ".join(
        f"{n} {1000 * v / units:.3f}" for n, v in att["idle_by_span"]))
    return out


def export_trace(prof, path: Path) -> Path:
    """The profiler's Chrome trace with the program tracer's spans laid
    in as a process of their own (``repro spans``), on the profiler's
    clock through the tracer's epoch anchor: one file for Perfetto, the
    spans with their arguments (``layer``, ``tokens``, ``microbatch``)
    above the kernels they launched."""
    from repro_torch.obs import export
    from repro_torch.obs import tracer as obs

    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc.get("baseTimeNanoseconds", 0) / 1000
    pid = max([e["pid"] for e in doc["traceEvents"]
               if isinstance(e.get("pid"), int)] + [0]) + 1
    for ev in export.chrome_trace(obs.get_tracer(), epoch=True,
                                  process_name="repro spans")["traceEvents"]:
        ev["pid"] = pid
        if "ts" in ev:
            ev["ts"] -= base_us
        doc["traceEvents"].append(ev)
    path.write_text(json.dumps(doc))
    return path


def _profiled(unit, units: int, sync, export: Path | None = None) -> dict:
    """``units`` units under the profiler, reduced: the window's and the
    reduction's seconds, the busy union's seconds, the kernels (counted,
    and by name), the annotations' device shadows and ``attribute``'s
    spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import trace as TR
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        sync()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dev, host, shadows = split(prof.profiler.kineto_results.events())
    busy = TR._merge([(e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in dev])
    out = attribute(dev, host, busy)
    out.update(window_s=window_s, process_s=time.perf_counter() - t1,
               busy_s=sum(e - s for s, e in busy) / 1e9,
               kernel_names=Counter(e.name()[:80] for e in dev
                                    if TR._activity(e) == "kernel"),
               device_annotations=dict(shadows))
    out["kernels"] = sum(out["kernel_names"].values())
    if export is not None:
        export_trace(prof, export)
    return out


@contextlib.contextmanager
def _tracing(on: bool = True):
    """The program's tracer on (``on``), the one before it restored
    after."""
    from repro_torch.obs import tracer as obs

    if not on:
        yield
        return
    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        yield
    finally:
        obs.set_tracer(prev)


def _timed(unit, units: int, sync) -> float:
    sync()
    t0 = time.perf_counter()
    for _ in range(units):
        unit()
    sync()
    return time.perf_counter() - t0


def measure(name: str, seed: int, units: int | None = None, *,
            root: Path = ROOT, device: str = "cuda",
            config_override: dict | None = None,
            traffic_override: dict | None = None,
            export: Path | None = None) -> dict:
    """One cell's units timed with the tracer off and on, in the order
    off, on, on, off; then profiled the same way (off is the benchmark's
    traced run).  The metrics are read from both traced profiles, the
    table from the first, which ``export`` (a path) writes as one
    Perfetto trace of kernels and spans; ``kernels_lost`` and
    ``kernels_gained`` compare its kernels by name with the first
    untraced profile's."""
    from bench import harness

    spec = harness.load_json(root / "BENCHMARK.json")
    cs = harness.cell_spec(spec, name, root)
    kind = harness.load_module(
        root / "bench" / "kinds" / f"{cs['work']['kind']}.py",
        f"bench.kinds.{cs['work']['kind']}")
    cell = harness.build(cs, seed, root=root, device=device,
                         config_override=config_override,
                         traffic_override=traffic_override)
    kind.setup(cell)
    units = units or cell.traffic["trace_units"]
    unit = lambda: kind.unit(cell)     # noqa: E731
    order = (False, True, True, False)
    timed, prof = {False: [], True: []}, {False: [], True: []}
    for on in order:
        with _tracing(on):
            timed[on].append(_timed(unit, units, cell.sync))
    for on in order:
        with _tracing(on):
            first = on and not prof[True]
            prof[on].append(_profiled(unit, units, cell.sync,
                                      export if first else None))
    off, att = prof[False][0], prof[True][0]
    out = {"workload": name, "seed": seed, "units": units,
           "plain_s": timed[False], "tracer_s": timed[True],
           "profiled_s": [p["window_s"] for p in prof[False]],
           "profiled_traced_s": [p["window_s"] for p in prof[True]],
           "process_s": [p["process_s"] for p in prof[True]],
           "kernels_untraced": [p["kernels"] for p in prof[False]],
           "kernels": [p["kernels"] for p in prof[True]],
           "kernels_lost": (off["kernel_names"] -
                            att["kernel_names"]).most_common(5),
           "kernels_gained": (att["kernel_names"] -
                              off["kernel_names"]).most_common(5),
           "device_annotations": att["device_annotations"],
           "busy_s_untraced": [p["busy_s"] for p in prof[False]],
           "busy_s": [p["busy_s"] for p in prof[True]],
           "attributed_share": (att["attributed_s"] / att["busy_s"]
                                if att["busy_s"] else None),
           "idle_by_span": att["idle_by_span"],
           "spans": att["spans"]}
    wanted = [m for m in METRICS if m.endswith("." + cs["work"]["kind"])]
    out["metrics"] = {m: [metric(m, p, units) for p in prof[True]]
                      for m in wanted}
    if device != "cpu":
        out["power"] = harness.power_limit()
    out["table"] = table(att, att["busy_s"], units)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--export", type=Path, default=None, metavar="PATH",
                    help="write the first traced profile's kernels and "
                    "spans as one Chrome trace (JSON) for Perfetto")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    harness.set_cache_dirs(ROOT)
    out = measure(args.workload, args.seed, args.units, export=args.export)
    for line in out.pop("table"):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
