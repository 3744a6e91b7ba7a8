"""Device time by program span (``bench/spans.py``): on synthetic event
lists shaped as ``torch.profiler``'s kineto events, and on the CPU
profiler's own events of a small Mamba2 train step."""
import json
from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench import smoke
from bench import spans as SP
from bench import trace as TR


class Ev:
    """A kineto event's accessors over plain fields."""

    def __init__(self, name, start, dur, *, dev=False, act=None, corr=0,
                 linked=0, seq=-1, fwd=0, tid=1):
        self.f = dict(name=name, start=start, dur=dur, dev=dev,
                      act=act or ("kernel" if dev else "cpu_op"), corr=corr,
                      linked=linked, seq=seq, fwd=fwd, tid=tid)

    def name(self):
        return self.f["name"]

    def device_type(self):
        return DeviceType.CUDA if self.f["dev"] else DeviceType.CPU

    def activity_type(self):
        return self.f["act"]

    def is_user_annotation(self):
        return self.f["act"] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self.f["start"]

    def duration_ns(self):
        return self.f["dur"]

    def correlation_id(self):
        return self.f["corr"]

    def linked_correlation_id(self):
        return self.f["linked"]

    def sequence_nr(self):
        return self.f["seq"]

    def fwd_thread_id(self):
        return self.f["fwd"]

    def start_thread_id(self):
        return self.f["tid"]


def span(name, start, dur, tid=1, corr=0):
    return Ev(name, start, dur, act="user_annotation", tid=tid, corr=corr)


def kernel(linked, start, dur, name="k"):
    return Ev(name, start, dur, dev=True, linked=linked)


def _step():
    """One step's shape: a forward op in ``mamba.ssd`` (node 7), the
    backward on the engine's thread 2 with the recompute's ``mamba.ssd``
    inside ``train.backward`` (thread 1), the node's backward, an
    engine-side op outside any node, and a launch known to nothing."""
    ev = [span("train.step", 0, 1000, corr=1),
          span("mamba.ssd", 10, 100, corr=2),
          Ev("aten::mm", 20, 10, corr=3, seq=7),          # forward op
          span("train.backward", 200, 700, corr=4),
          span("mamba.ssd", 300, 100, tid=2, corr=5),     # recompute
          Ev("aten::mm", 310, 10, corr=6, seq=40, tid=2),
          Ev("MmBackward0", 500, 100, corr=7, seq=7, fwd=1, tid=2),
          Ev("aten::mm", 510, 10, corr=8, tid=2),
          Ev("aten::add", 650, 10, corr=9, tid=2),         # engine's own
          Ev("aten::mul", 950, 10, corr=10)]               # train.step self
    ev += [kernel(3, 25, 40), kernel(6, 320, 30), kernel(8, 520, 50),
           kernel(9, 660, 20), kernel(10, 960, 10), kernel(99, 980, 5),
           Ev("mamba.ssd", 20, 60, dev=True, act="gpu_user_annotation")]
    return ev


class OldEv(Ev):
    """An event of a release without ``activity_type`` (torch 2.11), where
    ``is_user_annotation`` marks the annotations on both sides."""

    activity_type = None

    def is_user_annotation(self):
        return self.f["act"] in ("user_annotation", "gpu_user_annotation")


def _old(events):
    out = []
    for e in events:
        o = OldEv(e.f["name"], e.f["start"], e.f["dur"])
        o.f = e.f
        out.append(o)
    return out


def _busy(dev):
    return TR._merge([(e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in dev])


def _att(events):
    dev, host, _ = SP.split(events)
    return SP.attribute(dev, host, _busy(dev))


def test_annotation_device_events_are_not_device_work():
    dev, host, shadows = SP.split(_step())
    assert len(dev) == 6 and len(host) == 10
    assert all(TR._activity(e) == "kernel" for e in dev)
    assert shadows == {"mamba.ssd": 1}
    busy = _busy(dev)
    assert sum(e - s for s, e in busy) == 155
    # the shadow's time would have been busy time: 20..80 covers 25..65
    assert sum(e - s for s, e in _busy(dev + [_step()[-1]])) == 175


def test_launches_go_to_their_span_and_phase():
    att = _att(_step())
    ssd, back = att["spans"]["mamba.ssd"], att["spans"]["train.backward"]
    assert ssd["forward"] == pytest.approx(40e-9)
    assert ssd["recompute"] == pytest.approx(30e-9)
    assert ssd["backward"] == pytest.approx(50e-9)   # through node 7
    assert ssd["kernels"] == dict.fromkeys(SP.PHASES, 1)
    assert ssd["calls"] == 2
    assert back["backward"] == pytest.approx(20e-9)  # the engine's own
    assert att["spans"]["train.step"]["forward"] == pytest.approx(10e-9)


def test_events_without_activity_type_give_the_same_attribution():
    """A runtime call is told by its name; one whose correlation id is an
    operator's as well does not take the operator's place."""
    ev = _step() + [Ev("cudaLaunchKernel", 975, 2, act="cuda_runtime",
                       corr=3, tid=9)]
    assert _att(_old(ev)) == _att(ev)
    assert _att(ev)["spans"]["mamba.ssd"]["forward"] == \
        pytest.approx(40e-9)


def test_no_span_collects_the_rest():
    att = _att(_step())
    assert att["spans"][SP.NO_SPAN]["forward"] == pytest.approx(5e-9)
    assert att["attributed_s"] == pytest.approx(150e-9)
    lines = SP.table(att, 155e-9, 1)
    assert lines[-3].startswith(SP.NO_SPAN)
    assert "96.77%" in lines[-2]
    # without any span every launch is (no span), and reported as such
    bare = _att([Ev("aten::mm", 0, 10, corr=3), kernel(3, 1, 5)])
    assert set(bare["spans"]) == {SP.NO_SPAN}
    assert bare["spans"][SP.NO_SPAN]["kernels"]["forward"] == 1


def test_idle_gaps_are_named_by_the_span_open_there():
    """Each gap goes to the innermost span open at its midpoint on any
    thread: before the first kernel inside the forward's ``mamba.ssd``,
    three inside ``train.backward``, the rest in ``train.step``'s own
    time, up to the trace's last host event at 1000."""
    idle = dict(_att(_step())["idle_by_span"])
    assert idle == pytest.approx({"mamba.ssd": 25e-9,
                                  "train.backward": 540e-9,
                                  "train.step": 280e-9})


def test_metrics_sum_their_spans_and_phases():
    att = _att(_step())
    assert SP.metric("ssd_ms.train", att, 1) == pytest.approx(120e-6)
    assert SP.metric("recompute_ms.train", att, 2) == pytest.approx(15e-6)
    assert SP.metric("proj_ms.train", att, 1) == 0.0
    assert set(SP.METRICS) == {
        "ssd_ms.prefill", "ssd_ms.train", "proj_ms.prefill", "proj_ms.train",
        "adamw_ms.train", "recompute_ms.train"}


def test_metrics_are_none_without_spans():
    assert SP.metric("ssd_ms.prefill", None, 3) is None
    bare = _att([Ev("aten::mm", 0, 10, corr=3), kernel(3, 1, 5)])
    assert SP.metric("ssd_ms.prefill", bare, 1) is None
    # spans but no device time: a CPU run
    cpu = _att([span("mamba.ssd", 0, 10)])
    assert SP.metric("ssd_ms.prefill", cpu, 1) is None


def _smoke_model():
    from repro_torch.configs.base import load_config
    from repro_torch.models.model import build_model

    cfg = load_config("mamba2_2_7b", smoke=True).replace(
        compute_dtype=torch.float32, remat="full")
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def _smoke_batch():
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, 512, (4, 32), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}


def _profiled(run, export=None):
    """``run()`` under the CPU profiler with the program's tracer on; the
    profiler, and the trace ``export_trace`` wrote to ``export``."""
    from repro_torch.obs import tracer as obs

    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        path = None if export is None else SP.export_trace(prof, export)
    finally:
        obs.set_tracer(prev)
    return prof, path


def test_cpu_step_recomputes_each_ssd_op_once_under_full_remat():
    """The profiler's own events: the SSD's products in a train step
    with 2 microbatches and full remat, each op taken as a launch, give
    as many recompute launches as forward ones and their backward."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step

    model = _smoke_model()
    step = make_train_step(model, adamw.AdamWConfig(), 2)
    state = adamw.init_state(model)
    events = _profiled(lambda: step(model, state, _smoke_batch()))[0]\
        .profiler.kineto_results.events()
    leaves = [e for e in events if e.name() in ("aten::mm", "aten::bmm")]
    got = Counter(SP.Host(events).resolve(
        [(e.start_ns(), e.start_thread_id()) for e in leaves]))
    assert got[("mamba.ssd", "recompute")] == got[("mamba.ssd", "forward")] > 0
    assert got[("mamba.ssd", "backward")] > 0
    assert got[("mamba.proj", "recompute")] == got[("mamba.proj", "forward")]
    assert got[(SP.NO_SPAN, "forward")] == 0


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill_4k",
                                      "mamba2-2.7b.train_4k"])
def test_measure_runs_a_cell_at_small_size_on_the_cpu(workload):
    kw = smoke.kwargs(workload)
    kw.pop("limits_override")
    out = SP.measure(workload, 7, 1, **kw)
    assert out["kernels"] == out["kernels_untraced"] == [0, 0]
    assert out["kernels_lost"] == out["kernels_gained"] == []
    kind = workload.split("_")[0].split(".")[-1]
    assert set(out["metrics"]) == {m for m in SP.METRICS
                                   if m.endswith(f".{kind}")}
    assert all(v == [None, None] for v in out["metrics"].values())
    assert out["table"][-3].startswith(SP.NO_SPAN)


def test_export_lays_the_spans_over_the_profiler_trace(tmp_path):
    """``--export``: the profiler's Chrome trace with the tracer's spans
    as a process of their own, each within 1 ms of the profiler's range
    of the same name and call, with its arguments."""
    from repro_torch.train.serve import make_prefill

    model = _smoke_model()
    tokens = _smoke_batch()["tokens"]
    _, path = _profiled(lambda: make_prefill(model)({"tokens": tokens}),
                        tmp_path / "out" / "trace.json")
    evs = json.loads(path.read_text())["traceEvents"]
    pid = next(e["pid"] for e in evs if e.get("ph") == "M" and
               e["args"].get("name") == "repro spans")
    mine = [e for e in evs if e.get("ph") == "X" and e["pid"] == pid]
    theirs = [e for e in evs if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in mine) == \
        sorted(e["name"] for e in theirs)
    for name in {e["name"] for e in mine}:
        a = sorted(e["ts"] for e in mine if e["name"] == name)
        b = sorted(e["ts"] for e in theirs if e["name"] == name)
        assert max(abs(x - y) for x, y in zip(a, b)) < 1000, name
    L = model.cfg.num_layers
    ssd = sorted((e for e in mine if e["name"] == "mamba.ssd"),
                 key=lambda e: e["ts"])
    assert [e["args"]["layer"] for e in ssd] == list(range(L))
    assert {e["args"]["tokens"] for e in ssd} == {tokens.numel()}
    assert any(e.get("cat") == "cpu_op" for e in evs)
