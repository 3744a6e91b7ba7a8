"""The port's trace export (``repro_torch.obs.export``) and wave report
(``repro_torch.analysis.wave_report``) against the reference's.

* A trace written by the port (its ``torch`` backend on the CPU, traced)
  and one written by the reference (its ``jax`` backend, whose kernels land
  on ``device:<id>`` tracks) read back equal through both packages'
  ``load_events``, in both formats (Chrome trace-event JSON and JSONL).
* ``wave_report`` and ``format_wave_report`` give the reference's report
  and table on the same files: on those two traces and on synthetic traces
  that are kernel-bound, lock-bound and device-imbalanced with one flagged
  straggler.
* ``scripts/analyze_torch.py --trace-report`` prints what
  ``scripts/analyze.py --trace-report`` prints.
* The executor's device-track ``wave.kernel`` spans sum to ``kernel_ns``
  on every traced wave (the span carries the kernel's interval, not the
  launch's).

Everything is compared for equality: both packages run the same Python on
the same numbers."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import wave_report as r_wr
from repro.core import batch_sim as r_bs
from repro.core.isa import TEST_ISA as R_TEST_ISA
from repro.obs import export as r_export
from repro.obs import tracer as r_obs
from repro_torch.analysis import wave_report as p_wr
from repro_torch.obs import export as p_export
from repro_torch.obs import tracer as p_obs

from test_torch_batch_sim import (_interesting_wave, _port_codes,
                                  _port_machine, _sim)

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ("chrome", "jsonl")


def _write(export, tracer, path, fmt):
    if fmt == "chrome":
        return export.write_chrome_trace(path, tracer)
    return export.write_jsonl(path, tracer)


def _traced(obs, run):
    """Run ``run()`` under a fresh enabled tracer of ``obs``; return the
    tracer and what ``run`` returned."""
    tr = obs.Tracer(enabled=True)
    prev = obs.set_tracer(tr)
    try:
        out = run()
    finally:
        obs.set_tracer(prev)
    return tr, out


@pytest.fixture(scope="module")
def port_trace():
    """A traced run of the port's executor: three waves of one machine."""
    _, _, pa, pi = _sim("sim_skl")
    m = _port_machine(pa, pi)
    codes = _port_codes(_interesting_wave(R_TEST_ISA))

    def run():
        for n in (len(codes), 9, 30):
            m.run_batch(codes[:n])
        return m.device_stats()
    return _traced(p_obs, run)


@pytest.fixture(scope="module")
def ref_trace():
    """A traced run of the reference's ``jax`` executor."""
    pytest.importorskip("jax")
    ra, ri, _, _ = _sim("sim_skl")
    m = r_bs.BatchSimMachine(ra, ri, backend="jax", min_lanes=1)
    codes = _interesting_wave(ri)
    return _traced(r_obs, lambda: m.run_batch(codes))


def _synthetic(obs, kind):
    """A trace of one shape of bottleneck, written through ``obs``'s own
    tracer: 4 devices x 6 waves of kernel spans plus host stages."""
    tr = obs.Tracer(enabled=True)
    t0 = tr.t0_ns
    us = 1000
    for w in range(6):
        base = t0 + w * 10_000 * us
        tr.emit_span("scheduler.execute", base, 9_000 * us, wave=64 + w,
                     plans=3 + w)
        tr.emit_span("wave.run_batch", base, 8_000 * us, lanes=64)
        tr.emit_span("wave.lower", base, 500 * us)
        tr.emit_span("wave.pack", base + 500 * us, 200 * us)
        tr.emit_span("wave.dispatch", base + 700 * us, 100 * us)
        for d in range(4):
            dur = 3_000 * us
            if kind == "imbalanced" and d == 3:
                dur *= 6          # one slow device: a straggler
            tr.emit_span("wave.kernel", base + 800 * us, dur,
                         track=f"device:{d}", lanes=16)
        if kind == "lock":
            tr.emit_span("wave.lock_wait", base, 7_000 * us)
            tr.emit_span("wave.dispatch_lock_wait", base, 2_000 * us)
        tr.emit_span("wave.result_wait", base + 3_800 * us, 100 * us)
        tr.emit_span("wave.extract", base + 3_900 * us, 300 * us)
        tr.counter("scheduler.wave_width", 64 + w)
        tr.instant("engine.quarantine", spec="X")
    return tr


def _assert_same_reading(path):
    got, want = p_export.load_events(path), r_export.load_events(path)
    assert got == want
    assert got
    return got


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_trace_reads_back_equal_through_both_packages(port_trace, fmt,
                                                           tmp_path):
    tr, _ = port_trace
    path = tmp_path / f"port.{fmt}"
    assert _write(p_export, tr, path, fmt) == str(path)
    events = _assert_same_reading(path)
    assert any(e["name"] == "wave.kernel" and e["tid_name"] == "device:cpu"
               for e in events)
    # the exporters are the reference's: the same tracer's events render
    # to the same document
    assert p_export.chrome_trace(tr) == r_export.chrome_trace(tr)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_trace_reads_back_equal_through_both_packages(ref_trace,
                                                                fmt,
                                                                tmp_path):
    tr, _ = ref_trace
    path = tmp_path / f"ref.{fmt}"
    _write(r_export, tr, path, fmt)
    events = _assert_same_reading(path)
    assert any(e["name"] == "wave.kernel"
               and str(e["tid_name"]).startswith("device:") for e in events)


def test_both_formats_carry_the_same_events(port_trace, tmp_path):
    """Chrome and JSONL give the same ``ph``, ``name``, ``ts_us``,
    ``dur_us`` and ``args`` event for event (the Chrome format renumbers
    the ``tid``s) and the same report."""
    tr, _ = port_trace
    a, b = tmp_path / "t.json", tmp_path / "t.jsonl"
    p_export.write_chrome_trace(a, tr)
    p_export.write_jsonl(b, tr)
    ea, eb = p_export.load_events(a), p_export.load_events(b)
    keys = ("ph", "name", "ts_us", "dur_us", "args")
    assert [[e[k] for k in keys] for e in ea] == \
        [[e[k] for k in keys] for e in eb]
    assert p_wr.wave_report(ea) == p_wr.wave_report(eb)


def _reports(path, top=5):
    got = p_wr.report_from_file(path, top=top)
    want = r_wr.report_from_file(path, top=top)
    assert got == want
    assert p_wr.format_wave_report(got) == r_wr.format_wave_report(want)
    return got


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("source", ["port", "reference"])
def test_wave_report_on_real_traces_equals_the_reference(source, fmt,
                                                         port_trace,
                                                         ref_trace,
                                                         tmp_path):
    tr, _ = port_trace if source == "port" else ref_trace
    export = p_export if source == "port" else r_export
    path = tmp_path / f"trace.{fmt}"
    _write(export, tr, path, fmt)
    rep = _reports(path, top=3)
    assert rep["stages"]["kernel"]["count"] > 0
    assert rep["waves"] >= 1


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind,bottleneck", [
    ("kernel", "kernel-bound"), ("lock", "lock-bound"),
    ("imbalanced", "device-imbalanced")])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wave_report_classifies_as_the_reference(writer, kind, bottleneck,
                                                 fmt, tmp_path):
    obs, export = ((p_obs, p_export) if writer == "port"
                   else (r_obs, r_export))
    path = tmp_path / f"{kind}.{fmt}"
    _write(export, _synthetic(obs, kind), path, fmt)
    rep = _reports(path)
    assert rep["bottleneck"] == bottleneck
    assert len(rep["devices"]) == 4
    assert len(rep["top_waves"]) == 5 and rep["waves"] == 6
    flagged = rep["stragglers"]["flagged"]
    assert flagged == (["device:3"] if kind == "imbalanced" else [])
    if flagged:
        assert "stragglers (EWMA" in p_wr.format_wave_report(rep)


def test_device_kernel_spans_sum_to_kernel_ns():
    """On every traced wave the port executor's device-track
    ``wave.kernel`` spans sum to the growth of its ``kernel_ns``: the span
    is the kernel's interval, recorded when the outputs reach the host."""
    _, _, pa, pi = _sim("sim_hsw")
    m = _port_machine(pa, pi)
    codes = _port_codes(_interesting_wave(R_TEST_ISA))
    tr = p_obs.Tracer(enabled=True)
    prev = p_obs.set_tracer(tr)
    try:
        seen, spans_before, calls_before = 0, 0, 0
        for n in (len(codes), 5, 17, len(codes)):
            m.run_batch(codes[:n])
            st = m.device_stats()
            spans = [e for e in tr.events() if e["name"] == "wave.kernel"]
            assert all(e["tid"] == "device:cpu" for e in spans)
            assert all(set(e["args"]) == {"lanes", "steps"} for e in spans)
            assert sum(e["dur"] for e in spans) == st["kernel_ns"][
                "device:cpu"]
            new = len(spans) - spans_before
            assert new == st["kernel_calls"] - calls_before > 0
            spans_before, calls_before = len(spans), st["kernel_calls"]
            seen += new
    finally:
        p_obs.set_tracer(prev)
    assert seen == m.device_stats()["kernel_calls"]


def _script(script, *args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / script),
                           *map(str, args)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("fmt,extra", [
    ("chrome", ()), ("jsonl", ()), ("chrome", ("--top-waves", "2")),
    ("jsonl", ("--json",))])
def test_analyze_torch_trace_report_prints_the_reference_output(
        port_trace, fmt, extra, tmp_path):
    tr, _ = port_trace
    path = tmp_path / f"trace.{fmt}"
    _write(p_export, tr, path, fmt)
    want = _script("scripts/analyze.py", "--trace-report", path, *extra)
    got = _script("scripts/analyze_torch.py", "--trace-report", path, *extra)
    assert got == want
    if extra == ("--json",):
        assert json.loads(got)["stages"]["kernel"]["count"] > 0
    else:
        assert "bottleneck:" in got
