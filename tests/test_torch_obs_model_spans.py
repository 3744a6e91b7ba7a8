"""The model path's spans (``repro_torch.obs``), on the CPU.

* Disabled, ``obs.span`` is the shared no-op and enters no
  ``record_function``: a traced prefill under the profiler carries no
  annotation.
* Enabled under ``torch.profiler``, a span is a user annotation of its own
  name in the profiler's trace, and the export's epoch timestamps
  (``chrome_trace(epoch=True)``, through ``Tracer.t0_epoch_ns``) lie
  within 1 ms of the annotation's ``start_ns()``; ``chip_smoke.py``'s
  device time leaves those annotations out.
* A Mamba2 train step at the smoke config with 2 microbatches and full
  remat enters ``mamba.ssd`` 2 x layers x 2 times, half of them inside
  ``train.backward`` (the recompute); the spans carry their work counts.
* Tracing on (tracer and profiler) changes no value: the loss, the
  gradients and the weights after a step under each remat setting, and
  prefill's logits and decode state, bit for bit.

Imports no jax."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import load_config
from repro_torch.models.model import build_model
from repro_torch.obs import export
from repro_torch.obs import tracer as obs
from repro_torch.optim import adamw
from repro_torch.train.serve import make_prefill
from repro_torch.train.train_loop import make_train_step

REMATS = ("none", "full", "dots", "tp_out")
B, S = 4, 32


def _cfg(remat="full"):
    return load_config("mamba2_2_7b", smoke=True).replace(
        compute_dtype=torch.float32, remat=remat)


def _model(cfg):
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def _batch():
    g = torch.Generator().manual_seed(1)
    return {k: torch.randint(0, 512, (B, S), generator=g, dtype=torch.int32)
            for k in ("tokens", "labels")}


def _traced(run, on: bool):
    """``run()`` under the profiler (CPU) with the tracer on or off; the
    tracer, the profiler's events and what ``run`` returned."""
    tr = obs.Tracer(enabled=on)
    prev = obs.set_tracer(tr)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = run()
    finally:
        obs.set_tracer(prev)
    return tr, prof.profiler.kineto_results.events(), out


def _annotations(events):
    return [e for e in events if e.is_user_annotation()]


def test_disabled_span_is_the_no_op_and_enters_no_record_function(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    prev = obs.set_tracer(obs.Tracer(enabled=False))
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            sp = obs.span("mamba.ssd", layer=0)
            assert sp is obs.NULL_SPAN
            with sp:
                pass
    finally:
        obs.set_tracer(prev)


def test_disabled_prefill_leaves_no_annotation():
    model = _model(_cfg())
    _, events, _ = _traced(
        lambda: make_prefill(model)({"tokens": _batch()["tokens"]}), False)
    assert _annotations(events) == []


def test_enabled_span_is_an_annotation_on_the_profiler_clock():
    def run():
        with obs.span("a.outer", n=1):
            with obs.span("a.inner"):
                torch.ones(8).sum()

    _traced(run, True)       # the first range's set-up is not the clock's
    tr, events, _ = _traced(run, True)
    ann = {e.name(): e for e in _annotations(events)}
    assert sorted(ann) == ["a.inner", "a.outer"]
    got = {ev["name"]: ev["ts"] for ev in
           export.chrome_trace(tr, epoch=True)["traceEvents"]
           if ev["ph"] == "X"}
    for name, e in ann.items():
        assert abs(got[name] * 1000 - e.start_ns()) < 1e6, name


def test_chip_smoke_device_time_leaves_the_span_ranges_out():
    """``chip_smoke.py``'s ``_device_us`` sums kernels (or operators) only:
    the span ranges the tracer opens under its profiler, and their device
    shadows over whole waves, are neither; ``key_averages()`` marks them
    ``is_user_annotation``."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def row(key, dev, ann, us):
        return SimpleNamespace(
            key=key, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
            is_user_annotation=ann, self_device_time_total=us, count=2)

    rows = [row("k", True, False, 5.0), row("wave.run_batch", True, True, 9e2),
            row("aten::mm", False, False, 4.0), row("wave.kernel", False,
                                                    True, 3.0)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert cs._device_us(prof) == {"k": (5.0, 2)}
    assert cs._device_us(prof, operators=True) == {"aten::mm": (4.0, 2)}
    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with obs.span("wave.run_batch"):
                torch.ones(8).sum()
    finally:
        obs.set_tracer(prev)
    marks = {a.key: a.is_user_annotation for a in p.key_averages()}
    assert marks["wave.run_batch"] is True
    assert not marks["aten::sum"]


def test_clear_takes_a_new_epoch_anchor():
    tr = obs.Tracer(enabled=True)
    a = (tr.t0_ns, tr.t0_epoch_ns)
    tr.clear()
    assert tr.t0_ns > a[0] and tr.t0_epoch_ns >= a[1]


def _train(remat, on: bool, microbatches: int = 2):
    cfg = _cfg(remat)
    model = _model(cfg)
    step = make_train_step(model, adamw.AdamWConfig(), microbatches)
    state = adamw.init_state(model)
    tr, events, (_, _, metrics) = _traced(
        lambda: step(model, state, _batch()), on)
    return cfg, model, tr, events, metrics


def test_full_remat_enters_the_ssd_span_again_inside_the_backward():
    cfg, _, tr, events, _ = _train("full", True)
    evs = tr.events()
    ssd = [e for e in evs if e["name"] == "mamba.ssd"]
    back = [e for e in evs if e["name"] == "train.backward"]
    L = cfg.num_layers
    assert len(ssd) == 2 * L * 2
    inside = [e for e in ssd if any(
        b["t0"] <= e["t0"] and e["t0"] + e["dur"] <= b["t0"] + b["dur"]
        for b in back)]
    assert len(inside) == len(ssd) // 2
    # the work counts: tokens of a microbatch, layer indices in order
    assert {e["args"]["tokens"] for e in ssd} == {B // 2 * S}
    assert [e["args"]["layer"] for e in ssd[:L]] == list(range(L))
    assert [e["args"]["microbatch"] for e in back] == [0, 1]
    step = [e for e in evs if e["name"] == "train.step"]
    assert [e["args"]["tokens"] for e in step] == [B * S]
    assert sum(e["name"] == "optim.adamw" for e in evs) == 1
    # the profiler saw every span as an annotation of its name
    names = sorted(e.name() for e in _annotations(events))
    assert names == sorted(e["name"] for e in evs)


@pytest.mark.parametrize("remat", REMATS)
def test_tracing_changes_no_training_value(remat):
    runs = {on: _train(remat, on) for on in (False, True)}
    (_, m0, _, _, met0), (_, m1, _, _, met1) = runs[False], runs[True]
    for k in ("loss", "grad_norm"):
        assert torch.equal(met0[k], met1[k]), k
    s0, s1 = m0.state_dict(), m1.state_dict()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.parametrize("remat", REMATS)
def test_tracing_changes_no_gradient(remat):
    def grads(on):
        model = _model(_cfg(remat))
        model.requires_grad_(True)
        params = [p for _, p in model.named_parameters()]

        def run():
            loss, _ = model.loss(_batch())
            return loss, torch.autograd.grad(loss, params)

        return _traced(run, on)[2]

    (l0, g0), (l1, g1) = grads(False), grads(True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_tracing_changes_no_prefill_value():
    model = _model(_cfg())
    prefill = make_prefill(model)
    tokens = _batch()["tokens"]
    tr0, _, (lg0, st0) = _traced(lambda: prefill({"tokens": tokens},
                                                 pad_to=S + 8), False)
    tr1, _, (lg1, st1) = _traced(lambda: prefill({"tokens": tokens},
                                                 pad_to=S + 8), True)
    assert tr0.events() == []
    names = [e["name"] for e in tr1.events()]
    assert names.count("mamba.ssd") == model.cfg.num_layers
    assert names.count("serve.prefill") == 1
    assert torch.equal(lg0, lg1)
    for k in st0:
        assert torch.equal(st0[k], st1[k]), k
