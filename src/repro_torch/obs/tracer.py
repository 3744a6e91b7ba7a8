"""Thread-safe hierarchical spans with a near-zero disabled fast path.

Every instrumented seam in the repo calls the *module-level* helpers::

    from repro_torch import obs

    with obs.span("wave.execute", wave=len(codes)) as sp:
        ...
        sp.set(chunks=n)          # attach attributes mid-span

When tracing is disabled (the default) ``obs.span(...)`` returns a single
shared stateless no-op context manager — one attribute load, one truth
test, no allocation — so instrumentation costs a few tens of nanoseconds
per call site and nothing else.  Enable globally with ``REPRO_TRACE=1`` in
the environment, or programmatically::

    obs.set_tracer(obs.Tracer(enabled=True))
    ... traced work ...
    events = obs.get_tracer().events()

Design notes
------------
* Clocks are ``time.perf_counter_ns()`` (monotonic); export converts to
  the trace-event µs epoch relative to the tracer's start.  The tracer
  also keeps an epoch anchor, ``t0_epoch_ns`` (``time.time_ns()`` taken
  beside ``t0_ns``, at start and on ``clear()``), so
  ``export.chrome_trace(epoch=True)`` can state its events on the wall
  clock that ``torch.profiler``'s events carry (``start_ns()``:
  nanoseconds since the Unix epoch), and the spans line up with a
  profiler trace in Perfetto (``bench/spans.py --export``).
* While tracing is on and a ``torch.profiler`` session is recording, each
  span also opens a ``torch.profiler.record_function`` range of its own
  name, closed when the span closes: the span then sits in the profiler's
  (kineto) trace as a user annotation, on the thread that entered it and
  on the clock of the device's kernels, so device time can be told by the
  span that launched it.  The check is made on the enabled path only;
  torch is looked up among the loaded modules, never imported here.  The
  model path's spans (``serve.prefill``, ``train.step``,
  ``train.backward``, ``optim.adamw``, ``mamba.proj``, ``mamba.ssd``,
  ``mamba.out``; see :mod:`repro_torch.obs`) are read this way.
* Events append to one shared list — ``list.append`` is atomic under the
  GIL, so the hot path takes no lock.
* Each thread keeps its own span stack (``threading.local``) so nesting
  is tracked per thread and the tracer is reentrant across the Campaign
  pool.  A ``trace_id`` attribute set on an enclosing span is inherited
  by child spans on the same thread (how server request IDs flow into
  batch-predictor spans without threading them through every signature).
* ``track=`` pins an event to a named synthetic track (e.g. ``device:0``)
  instead of the calling thread — the export layer gives each track its
  own tid + thread-name metadata, which is how per-device kernel
  timelines appear in Perfetto.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_now = time.perf_counter_ns


class _NullSpan:
    """Shared no-op span: returned by every helper while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a
    ``torch.profiler`` session records, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """A live span: records one complete ("X") event when it exits."""

    __slots__ = ("_tracer", "name", "args", "track", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]], track: Optional[str]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.track = track

    def set(self, **attrs) -> "_Span":
        """Attach (or overwrite) key/value attributes mid-span."""
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)
        return self

    def __enter__(self):
        self._tracer._stack().append(self)
        self._t0 = _now()
        self._rf = _profiler_range(self.name)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = _now()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        args = self.args
        if (args is None or "trace_id" not in args):
            # inherit the nearest enclosing trace_id on this thread
            for sp in reversed(stack):
                a = sp.args
                if a is not None and "trace_id" in a:
                    args = dict(args) if args else {}
                    args["trace_id"] = a["trace_id"]
                    break
        tr._emit("X", self.name, self._t0, t1 - self._t0, args, self.track)
        return False


class _LockWait:
    """Context manager that times lock acquisition separately from the
    critical section, so contention shows up as its own span.

    Drives the lock through the context-manager protocol (not
    ``acquire``/``release``) so any ``with``-able lock the call sites
    already accepted keeps working; ``lock=None`` degrades to a pure
    no-op (the existing "no lock configured" behaviour is preserved
    bit-for-bit)."""

    __slots__ = ("_lock", "_name", "_tracer")

    def __init__(self, lock, name: str, tracer: Optional["Tracer"]):
        self._lock = lock
        self._name = name
        self._tracer = tracer

    def __enter__(self):
        if self._lock is None:
            return self
        tr = self._tracer
        if tr is None:
            self._lock.__enter__()
            return self
        t0 = _now()
        self._lock.__enter__()
        t1 = _now()
        tr._emit("X", self._name, t0, t1 - t0, None, None)
        return self

    def __exit__(self, *exc):
        if self._lock is not None:
            return self._lock.__exit__(*(exc or (None, None, None)))
        return False


class Tracer:
    """Collects trace events; one instance is installed globally.

    Thread-safe by construction: the event sink is a plain list (append is
    GIL-atomic) and span stacks are per-thread."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.t0_ns = _now()
        self.t0_epoch_ns = time.time_ns()
        self.pid = os.getpid()
        self._events: List[dict] = []
        self._local = threading.local()
        self._threads: Dict[int, str] = {}
        self._tracks: Dict[str, None] = {}

    # -- hot path ------------------------------------------------------
    def span(self, name: str, *, track: Optional[str] = None, **attrs):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs or None, track)

    def instant(self, name: str, *, track: Optional[str] = None, **attrs):
        """A zero-duration marker event."""
        if self.enabled:
            self._emit("i", name, _now(), 0, attrs or None, track)

    def counter(self, name: str, value, *, track: Optional[str] = None):
        """A sampled counter value (a counter track in Perfetto)."""
        if self.enabled:
            self._emit("C", name, _now(), 0, {"value": value}, track)

    def wait_lock(self, lock, name: str = "lock.wait"):
        if not self.enabled:
            return _LockWait(lock, name, None)
        return _LockWait(lock, name, self)

    # -- plumbing ------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, ph: str, name: str, t0: int, dur: int,
              args: Optional[dict], track: Optional[str]):
        if track is None:
            tid = threading.get_ident()
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
        else:
            tid = track
            self._tracks[track] = None
        self._events.append({"ph": ph, "name": name, "t0": t0, "dur": dur,
                             "tid": tid, "args": args})

    def emit_span(self, name: str, t0_ns: int, dur_ns: int, *,
                  track: Optional[str] = None, **attrs):
        """Record an already-timed interval (used by pool workers that
        measure with raw clocks and attribute the span to a device track)."""
        if self.enabled:
            self._emit("X", name, t0_ns, dur_ns, attrs or None, track)

    def events(self) -> List[dict]:
        """The raw event list (internal schema; see export.py for the
        Chrome trace-event rendering)."""
        return list(self._events)

    def clear(self):
        self._events.clear()
        self._threads.clear()
        self._tracks.clear()
        self.t0_ns = _now()
        self.t0_epoch_ns = time.time_ns()

    def thread_names(self) -> Dict[int, str]:
        return dict(self._threads)

    def tracks(self) -> List[str]:
        return list(self._tracks)


def _from_env() -> Tracer:
    flag = os.environ.get("REPRO_TRACE", "")
    return Tracer(enabled=flag not in ("", "0", "false", "off"))


_GLOBAL: Tracer = _from_env()


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` globally; returns the previous tracer so tests
    and benches can restore it."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


def enabled() -> bool:
    return _GLOBAL.enabled


# Module-level helpers: the instrumented call sites use these.  Each is a
# single global load + truth test when tracing is off.
def span(name: str, *, track: Optional[str] = None, **attrs):
    t = _GLOBAL
    if not t.enabled:
        return NULL_SPAN
    return _Span(t, name, attrs or None, track)


def instant(name: str, *, track: Optional[str] = None, **attrs):
    t = _GLOBAL
    if t.enabled:
        t._emit("i", name, _now(), 0, attrs or None, track)


def counter(name: str, value, *, track: Optional[str] = None):
    t = _GLOBAL
    if t.enabled:
        t._emit("C", name, _now(), 0, {"value": value}, track)


def wait_lock(lock, name: str = "lock.wait"):
    t = _GLOBAL
    if not t.enabled:
        return _LockWait(lock, name, None)
    return _LockWait(lock, name, t)


def emit_span(name: str, t0_ns: int, dur_ns: int, *,
              track: Optional[str] = None, **attrs):
    t = _GLOBAL
    if t.enabled:
        t._emit("X", name, t0_ns, dur_ns, attrs or None, track)
