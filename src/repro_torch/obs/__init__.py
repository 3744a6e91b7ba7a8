"""Unified observability: structured tracing + metrics for every layer.

The measurement stack is five layers deep (plans -> WaveScheduler ->
MeasurementEngine -> BatchSimMachine -> device mesh -> service), and each
layer grew its own ad-hoc stats dict.  This package is the one substrate
they all report through:

* :mod:`repro_torch.obs.tracer` — thread-safe hierarchical spans with monotonic
  clocks and a module-level no-op fast path (near-zero overhead when
  disabled; enable with ``REPRO_TRACE=1`` or ``Tracer(enabled=True)``).
  While enabled under a recording ``torch.profiler`` session, each span
  is also a ``record_function`` range of its name (a user annotation in
  the profiler's trace, on the device's clock); the tracer's epoch anchor
  ``t0_epoch_ns`` puts ``export.chrome_trace(epoch=True)`` on that clock
  too.
* :mod:`repro_torch.obs.metrics` — a counter/gauge/histogram registry with one
  ``snapshot()`` shape, absorbing the legacy stats dicts
  (``EngineStats.as_dict()``, ``device_stats()``, the server's per-endpoint
  summaries) behind canonical dotted instrument names.

* :mod:`repro_torch.obs.export` — Chrome trace-event JSON (Perfetto) and
  JSONL exporters, and ``load_events`` reading either back for
  :mod:`repro_torch.analysis.wave_report` (``scripts/analyze_torch.py
  --trace-report``).

Span names and metric alias tables are those of the reference package's
``repro.obs`` on the uops path (campaign, waves, service, corpus).  The
model path has its own spans, one a layer call, none inside a loop over
chunks or leaves: ``serve.prefill`` (``train/serve.py:make_prefill``,
``tokens=``), ``train.step`` (``train/train_loop.py:make_train_step``,
``tokens=``), ``train.backward`` (around ``torch.autograd.grad``,
``microbatch=``), ``optim.adamw`` (around ``adamw.apply_update``), and in
``models/mamba.py:mamba_block`` ``mamba.proj`` (the in-projections and
their weight casts), ``mamba.ssd`` (the chunked scan, its operand casts
and the ``D`` skip; ``tokens=``, ``route=`` ``"kernel"`` or ``"plain"``,
see ``models/mamba.py:ssd_route``) and ``mamba.out`` (gate, norm,
out-projection), each with ``layer=``.  Under activation checkpointing
the recompute enters the ``mamba.*`` spans again, inside the backward.
"""
from repro_torch.obs.tracer import (NULL_SPAN, Tracer, counter, enabled,
                                          get_tracer, instant, set_tracer, span,
                                          wait_lock)

__all__ = ["Tracer", "span", "instant", "counter", "wait_lock", "enabled",
           "get_tracer", "set_tracer", "NULL_SPAN"]
