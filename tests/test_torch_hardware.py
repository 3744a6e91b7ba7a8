"""The port's hardware-characterization path against the reference:
``corpus/jit_ops.py`` (the op corpus), ``core/hardware.py`` (Algorithm 2 in
wall clock) and ``core/kernel_bench.py`` (blocker contention).

The ops are compared on the same numpy inputs, handed to both packages:
rtol 1e-5 in f32 (sums taken in another order), 2e-2 in bf16 (bf16 rounds
at other places in the two frameworks).  The measurement protocols are
compared under one scripted clock: both modules' ``time`` is replaced by
the same sequence of readings, so the same calls in the same order give
the same numbers, exactly.
"""
import functools
import itertools
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hardware as r_hw
from repro.core import kernel_bench as r_kb
from repro.corpus.jit_ops import build_jit_corpus as r_build
from repro_torch.core import hardware as p_hw
from repro_torch.core import kernel_bench as p_kb
from repro_torch.corpus import build_jit_corpus as p_build
from repro_torch.kernels import microbench as pm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def test_corpus_names_dtypes_shapes_and_flops_equal_reference():
    ref = r_build()
    port = p_build(device="cpu")
    assert list(port) == list(ref)
    for name, (rf, rx, rflops) in ref.items():
        pf, px, pflops = port[name]
        assert pflops == rflops, name
        assert tuple(px.shape) == tuple(rx.shape), name
        assert str(px.dtype).removeprefix("torch.") == str(rx.dtype), name
        assert px.device.type == "cpu"
        np.testing.assert_allclose(_np(px), _np(rx), rtol=1e-6, atol=0,
                                   err_msg=name)


def _inputs(name, example, seed):
    """The corpus example, and a seeded random input of its shape and dtype
    (positive, so that rsqrt's argument stays in its domain)."""
    x = _np(example).copy()
    rng = np.random.default_rng(seed)
    return [x, rng.uniform(0.1, 1.0, x.shape).astype(np.float32)]


@pytest.mark.parametrize("size", [128, 256, 512])
def test_corpus_ops_equal_reference_ops(size):
    """One size per corpus: the reference's matmul ops then divide by their
    own size (see the next test)."""
    ref = r_build(sizes=(size,))
    port = p_build(sizes=(size,), device="cpu")
    for i, (name, (rf, rx, _)) in enumerate(ref.items()):
        if size != 128 and not name.startswith("matmul_"):
            continue        # the size-independent ops: once is enough
        pf, px, _ = port[name]
        for x in _inputs(name, rx, seed=size + i):
            want = _np(rf(jnp.asarray(x).astype(rx.dtype)))
            got = pf(torch.from_numpy(x).to(px.dtype))
            assert got.dtype == px.dtype and tuple(got.shape) == x.shape
            np.testing.assert_allclose(_np(got), want, rtol=TOL[px.dtype],
                                       atol=1e-6, err_msg=name)


def test_reference_matmul_ops_divide_by_the_last_size():
    """The reference's ``mm`` closes over its loop variable, so a corpus
    built with several sizes divides every matmul by the last one; the
    port divides each by its own size (ROADMAP §3)."""
    x = np.full((128, 128), 0.5, np.float32)
    ref_fn = r_build(sizes=(128, 512))["matmul_128x128_f32"][0]
    port_fn = p_build(sizes=(128, 512), device="cpu")["matmul_128x128_f32"][0]
    assert float(ref_fn(jnp.asarray(x))[0, 0]) == 128 * 0.25 / 512
    assert float(port_fn(torch.from_numpy(x))[0, 0]) == 128 * 0.25 / 128


class _Clock:
    """A scripted ``time`` module: perf_counter_ns walks a seeded random
    sequence (steps of 1..1e6 ns), so differences vary call to call and
    can go either way between two timings."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        steps = rng.integers(1, 10**6, 4096)
        self._it = itertools.accumulate(int(s) for s in steps)
        self.calls = 0

    def perf_counter_ns(self):
        self.calls += 1
        return next(self._it)


def _small_corpora():
    names = ("matmul_128x128_f32", "add_vec_64k", "transpose_256")
    ref = r_build(sizes=(128,))
    port = p_build(sizes=(128,), device="cpu")
    return ({n: ref[n] for n in names}, {n: port[n] for n in names})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measure_op_equals_reference_under_a_scripted_clock(monkeypatch,
                                                            seed):
    ref, port = _small_corpora()
    kw = {"n_small": 2, "n_large": 5, "lanes": 3}
    rclock, pclock = _Clock(seed), _Clock(seed)
    monkeypatch.setattr(r_hw, "time", rclock)
    monkeypatch.setattr(p_hw, "time", pclock)
    f, x, flops = ref["add_vec_64k"]
    want = r_hw.measure_op("add", f, x, flops=flops, **kw)
    f, x, flops = port["add_vec_64k"]
    got = p_hw.measure_op("add", f, x, flops=flops, device="cpu", **kw)
    assert astuple(got) == astuple(want)
    assert got.achieved_gflops == want.achieved_gflops
    want = r_hw.characterize_corpus(ref, **kw)
    got = p_hw.characterize_corpus(port, device="cpu", **kw)
    assert {k: astuple(v) for k, v in got.items()} == \
        {k: astuple(v) for k, v in want.items()}
    assert rclock.calls == pclock.calls == 4 * 10 * 4


@pytest.mark.parametrize("seed", [3, 4])
def test_profile_kernel_equals_reference_under_a_scripted_clock(monkeypatch,
                                                                seed):
    rclock, pclock = _Clock(seed), _Clock(seed)
    monkeypatch.setattr(r_kb, "time", rclock)
    monkeypatch.setattr(p_kb, "time", pclock)
    a = jnp.ones((16, 16), jnp.float32)
    v = jnp.ones((256,), jnp.float32)
    r_blockers = {"MXU": lambda: a @ a, "VPU": lambda: v * 1.0001 + 0.5,
                  "SFU": lambda: jnp.exp(v), "LSU": lambda: v + 1.0}
    p_blockers = {u: functools.partial(pm.BLOCKERS[u], device="cpu",
                                       **({"rows": 8} if u == "LSU" else
                                          {"iters": 2}))
                  for u in r_blockers}
    want = r_kb.profile_kernel("k", lambda: a @ a, r_blockers)
    t = torch.ones((16, 16))
    got = p_kb.profile_kernel("k", lambda: t @ t, p_blockers, device="cpu")
    assert (got.name, got.alone_ns, got.overlap) == \
        (want.name, want.alone_ns, want.overlap)
    assert got.likely_units() == want.likely_units()
    assert rclock.calls == pclock.calls == 10 * (1 + 2 * 4)


def test_measure_op_on_the_cpu_keeps_its_invariants():
    corpus = p_build(sizes=(128,), device="cpu")
    res = p_hw.characterize_corpus(corpus, device="cpu", n_small=2,
                                   n_large=6, lanes=2)
    assert list(res) == list(corpus)
    for name, m in res.items():
        assert m.name == name
        assert m.latency_ns >= 0 and m.throughput_ns >= 0
        assert m.flops == corpus[name][2]
        assert m.achieved_gflops >= 0


def test_profile_kernel_on_the_cpu_returns_every_blocker():
    blockers = {"MXU": functools.partial(pm.mxu_blocker, 4, 32,
                                         device="cpu"),
                "VPU": functools.partial(pm.vpu_blocker, 16, 8,
                                         device="cpu"),
                "SFU": functools.partial(pm.sfu_blocker, 16, 8,
                                         device="cpu"),
                "LSU": functools.partial(pm.lsu_blocker, 512, device="cpu")}
    before = dict(pm.launches)
    prof = p_kb.profile_kernel("vpu", blockers["VPU"], blockers,
                               device="cpu")
    assert prof.alone_ns > 0
    assert list(prof.overlap) == list(blockers)
    assert all(np.isfinite(c) for c in prof.overlap.values())
    assert pm.launches == before      # the CPU runs the plain versions
