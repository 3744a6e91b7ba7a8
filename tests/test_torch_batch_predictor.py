"""The port's ``BatchPredictor`` and its port-bound kernel's plain version
against the reference.

* The port's ``numpy`` and ``torch`` (``device="cpu"``) backends equal the
  reference's scalar ``predict``, its ``numpy`` backend and its ``jax``
  backend (``min_device_blocks=1``), as the bits of every float field, in
  two shape buckets, on all three simulated uarches.
* ``port_bound_ref`` equals the reference's jax kernel (reached through
  ``BatchPredictor._device_call``) as float64 quotients ``num / den`` on
  random, tie, all-zero and near-guard inputs.  Tied ratios may come back
  as different pairs, so the pairs themselves are not compared.
* Routing matches the reference: small waves stay on the host, and a
  non-integer uop count or the int32 overflow guard sends the wave to numpy
  and counts ``device_fallbacks``.
* ``cuda`` on a CPU device, or on a host without a card, raises; so does
  any backend name other than numpy/torch/cuda.

Models come from each package's ``Campaign`` over the reference tests'
``NAMES`` subset, with their XML checked equal."""
import copy
import struct
import threading

import numpy as np
import pytest
import torch

from repro.core import model_io as r_io
from repro.core.engine import Campaign as RCampaign
from repro.core.isa import TEST_ISA as R_ISA
from repro.core.predictor import predict as r_predict
from repro.core.simulator import Instr as RInstr
from repro.core.simulator import SimMachine as RSim
from repro.core.uarch import SIM_UARCHES as R_UARCHES
from repro.service.batch_predictor import BatchPredictor as RBP
from repro.service.workload import random_blocks as r_random_blocks
from repro_torch.core import model_io as p_io
from repro_torch.core.engine import Campaign as PCampaign
from repro_torch.core.isa import TEST_ISA as P_ISA
from repro_torch.core.simulator import Instr as PInstr
from repro_torch.core.simulator import SimMachine as PSim
from repro_torch.core.uarch import SIM_UARCHES as P_UARCHES
from repro_torch.kernels import port_bound as pb
from repro_torch.service.batch_predictor import BatchPredictor as PBP
from repro_torch.service.workload import random_blocks

NAMES = ["ADD_R64_R64", "IMUL_R64_R64", "MUL_R64", "ADC_R64_R64", "CMC",
         "TEST_R64_R64", "SHLD_R64_R64_I8", "MOVQ2DQ_X_X", "AESDEC_X_X",
         "PSHUFD_X_X", "PADDD_X_X", "MOV_R64_M64"]
UARCHES = sorted(R_UARCHES)
GUARD = 2 ** 31


@pytest.fixture(scope="module")
def models():
    """``{uarch: (reference model, port model)}``, XML byte-identical."""
    ref = RCampaign(instr_names=NAMES).run(
        [RSim(ua, R_ISA) for ua in R_UARCHES.values()], R_ISA).models
    port = PCampaign(instr_names=NAMES).run(
        [PSim(ua, P_ISA, backend="torch", device="cpu")
         for ua in P_UARCHES.values()], P_ISA).models
    for n in UARCHES:
        assert p_io.to_xml(port[n], P_ISA) == r_io.to_xml(ref[n], R_ISA)
    return {n: (ref[n], port[n]) for n in UARCHES}


def _bits(p):
    return (struct.pack("<4d", p.cycles, p.port_bound, p.latency_bound,
                        p.frontend_bound)
            + struct.pack(f"<{len(p.port_pressure)}d",
                          *p.port_pressure.values()),
            tuple(p.port_pressure), p.bottleneck)


def _r(code):
    return [RInstr(i.spec, dict(i.regs), i.value_hint) for i in code]


def _port(model, backend, **kw):
    return PBP(model, P_ISA, backend=backend,
               device=None if backend == "numpy" else "cpu", **kw)


# ----------------------------------------------------- predictions, bits

@pytest.mark.parametrize("seed,n", [(7, 64), (8, 5)], ids=["64", "5"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("uarch", UARCHES)
def test_backends_bit_identical_to_the_reference(models, uarch, backend,
                                                 seed, n):
    ref_model, port_model = models[uarch]
    blocks = random_blocks(port_model, P_ISA, n, seed=seed, max_len=8)
    rblocks = r_random_blocks(ref_model, R_ISA, n, seed=seed, max_len=8)
    assert [_r(b) for b in blocks] == rblocks     # same seed, same blocks
    got = _port(port_model, backend, min_device_blocks=1).predict_batch(
        blocks)
    scalar = [r_predict(ref_model, R_ISA, b) for b in rblocks]
    for other in (RBP(ref_model, R_ISA, backend="numpy"),
                  RBP(ref_model, R_ISA, backend="jax", min_device_blocks=1)):
        assert [_bits(p) for p in other.predict_batch(rblocks)] == \
            [_bits(p) for p in scalar]
    assert [_bits(p) for p in got] == [_bits(p) for p in scalar]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_backend_stats_match_the_reference(models, backend):
    ref_model, port_model = models["sim_skl"]
    blocks = random_blocks(port_model, P_ISA, 64, seed=7, max_len=8)
    bp = _port(port_model, backend, min_device_blocks=1)
    for _ in range(2):
        bp.predict_batch(blocks)
    st = bp.backend_stats()
    ref = RBP(ref_model, R_ISA, backend="numpy" if backend == "numpy"
              else "jax", min_device_blocks=1)
    for _ in range(2):
        ref.predict_batch(_r(b) for b in blocks)
    rst = ref.backend_stats()
    assert st["backend"] == backend
    assert set(st) == set(rst)
    for k in ("numpy_waves", "device_waves", "device_blocks",
              "device_fallbacks", "device_compiles"):
        assert st[k] == rst[k], k


def test_single_block_and_typed_errors(models):
    ref_model, port_model = models["sim_skl"]
    bp = _port(port_model, "torch")
    code = [PInstr("IMUL_R64_R64", {"op1": "R0", "op2": "R1"})]
    assert _bits(bp.predict(code)) == _bits(r_predict(ref_model, R_ISA,
                                                      _r(code)))
    bad = [PInstr("DIVPS_X_X", {"op1": "X0", "op2": "X1"})]
    out = bp.predict_batch([bad, code], on_error="return")
    assert out[0].missing == ["DIVPS_X_X"]
    assert _bits(out[1]) == _bits(bp.predict(code))
    with pytest.raises(KeyError):
        bp.predict_batch([bad])


def test_concurrent_callers_share_one_upload(models):
    """Server workers call one predictor at once: every thread gets its own
    results, the mask is uploaded once."""
    _, port_model = models["sim_hsw"]
    bp = _port(port_model, "torch", min_device_blocks=1)
    host = _port(port_model, "numpy")
    waves = [random_blocks(port_model, P_ISA, 40, seed=s, max_len=8)
             for s in range(8)]
    want = [[_bits(p) for p in host.predict_batch(w)] for w in waves]
    got = [None] * len(waves)

    def run(i):
        got[i] = [_bits(p) for p in bp.predict_batch(waves[i])]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got == want
    st = bp.backend_stats()
    assert st["device_compiles"] == 1 and st["device_waves"] == 8


def test_simulate_batch_equals_the_reference(models):
    ref_model, port_model = models["sim_skl"]
    blocks = random_blocks(port_model, P_ISA, 24, seed=5, max_len=4)
    port = PBP(port_model, P_ISA, backend="numpy",
               machine=PSim(P_UARCHES["sim_skl"], P_ISA, backend="torch",
                            device="cpu"))
    ref = RBP(ref_model, R_ISA, backend="numpy",
              machine=RSim(R_UARCHES["sim_skl"], R_ISA, backend="numpy"))
    got = port.simulate_batch(blocks, devices=[torch.device("cpu")])
    assert got == ref.simulate_batch([_r(b) for b in blocks])
    assert all(c > 0 for c in got)
    with pytest.raises(ValueError, match="machine"):
        _port(port_model, "numpy").simulate_batch(blocks)


# ------------------------------------------------------------- routing

def test_small_waves_stay_on_host(models):
    ref_model, port_model = models["sim_skl"]
    bp = _port(port_model, "torch")                   # default threshold
    ref = RBP(ref_model, R_ISA, backend="jax")
    blocks = random_blocks(port_model, P_ISA, 4, seed=3)
    assert [_bits(p) for p in bp.predict_batch(blocks)] == \
        [_bits(p) for p in ref.predict_batch([_r(b) for b in blocks])]
    for st in (bp.backend_stats(), ref.backend_stats()):
        assert st["device_waves"] == 0 and st["numpy_waves"] == 1


def _poisoned(model, value):
    """``model`` with ADD_R64_R64's first uop count set to ``value``."""
    model = copy.copy(model)
    model.instructions = dict(model.instructions)
    im = copy.deepcopy(model.instructions["ADD_R64_R64"])
    pc = next(iter(im.port_usage.usage))
    im.port_usage.usage[pc] = value(im.port_usage.usage[pc])
    model.instructions["ADD_R64_R64"] = im
    return model


@pytest.mark.parametrize("poison", [lambda n: n + 0.5, lambda n: 2 ** 28],
                         ids=["non-integer", "overflow-guard"])
def test_semantic_fallbacks_route_to_numpy(models, poison):
    ref_model, port_model = models["sim_skl"]
    ref_model, port_model = _poisoned(ref_model, poison), \
        _poisoned(port_model, poison)
    blocks = random_blocks(port_model, P_ISA, 39, seed=11)
    blocks.append([PInstr("ADD_R64_R64", {"op1": "R0", "op2": "R1"})])
    bp = _port(port_model, "torch", min_device_blocks=1)
    ref = RBP(ref_model, R_ISA, backend="jax", min_device_blocks=1)
    got = bp.predict_batch(blocks)
    want = ref.predict_batch([_r(b) for b in blocks])
    assert [_bits(p) for p in got] == [_bits(p) for p in want]
    assert [_bits(p) for p in got] == \
        [_bits(r_predict(ref_model, R_ISA, _r(b))) for b in blocks]
    st, rst = bp.backend_stats(), ref.backend_stats()
    assert st["device_fallbacks"] == rst["device_fallbacks"] == 1
    assert st["numpy_waves"] == rst["numpy_waves"] == 1
    assert st["device_waves"] == rst["device_waves"] == 0


def test_empty_blocks_give_zero(models):
    _, port_model = models["sim_snb"]
    bp = _port(port_model, "torch", min_device_blocks=1)
    out = bp.predict_batch([[]] * 3)
    assert [p.port_bound for p in out] == [0.0] * 3
    assert bp.backend_stats()["device_waves"] == 0


# ---------------------------------------------------- backends, defaults

def test_backend_env_knob_and_validation(models, monkeypatch):
    _, model = models["sim_skl"]
    monkeypatch.setenv("REPRO_PREDICT_BACKEND", "numpy")
    assert PBP(model, P_ISA).backend == "numpy"
    monkeypatch.setenv("REPRO_PREDICT_BACKEND", "torch")
    bp = PBP(model, P_ISA, device="cpu")
    assert bp.backend == "torch" and bp.device == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        PBP(model, P_ISA, backend="cuda", device="cpu")


def test_device_waves_go_through_the_kernel_wrapper(models, monkeypatch):
    """The ``torch`` backend calls the wrapper, which picks the kernel or
    its plain version by the tensors' device: on the CPU, the plain one."""
    _, model = models["sim_skl"]
    calls = []

    def wrapper(u, mask, size):
        calls.append(u.device)
        return pb.port_bound_ref(u, mask, size)

    monkeypatch.setattr(pb, "port_bound", wrapper)
    bp = _port(model, "torch", min_device_blocks=1)
    bp.predict_batch(random_blocks(model, P_ISA, 40, seed=5))
    assert calls == [torch.device("cpu")]
    assert bp.backend_stats()["device_waves"] == 1


@pytest.mark.parametrize("name", ["jax", "auto", "pallas", "gpu", ""])
def test_unknown_backend_names_raise(models, name):
    _, model = models["sim_skl"]
    with pytest.raises(ValueError, match="unknown predict backend"):
        PBP(model, P_ISA, backend=name, device="cpu")


def test_the_card_is_the_default_and_raises_without_one(models,
                                                        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    _, model = models["sim_skl"]
    monkeypatch.delenv("REPRO_PREDICT_BACKEND", raising=False)
    for kw in ({}, {"backend": "cuda"}, {"device": "cuda:0"},
               {"backend": "torch"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PBP(model, P_ISA, **kw)


# --------------------------------------- the kernel's plain version, jax

def _ref_kernel(mask, size):
    """The reference's jax kernel with ``mask``/``size`` in place of a
    model's, reached through ``BatchPredictor._device_call``."""
    bp = RBP.__new__(RBP)
    bp._combos = list(range(mask.shape[0]))
    bp._mask_i, bp._size_i = mask, size
    bp._dev_lock = threading.Lock()
    bp._dev_kernels, bp._dev_mask = {}, None
    bp._stats = {"device_compiles": 0}
    return bp._device_call


def _quotients(num, den):
    return (np.asarray(num, np.float64) / np.asarray(den, np.float64)) \
        .view(np.int64)


def _random_case(rng, B, C, S, hi=40):
    u = rng.integers(0, hi, (B, C), dtype=np.int32)
    mask = (rng.random((C, S)) < 0.4).astype(np.int32)
    size = rng.integers(1, 9, S, dtype=np.int32)
    return u, mask, size


def _cases():
    rng = np.random.default_rng(20)
    out = {}
    for B, C, S in ((1, 1, 1), (5, 11, 71), (33, 9, 31), (64, 11, 71),
                    (17, 32, 100)):
        out[f"random-{B}x{C}x{S}"] = _random_case(rng, B, C, S)
    # ties: every candidate the same ratio, and two winners of equal ratio
    u = np.full((12, 4), 3, np.int32)
    mask = np.eye(4, dtype=np.int32)
    out["all-tied"] = (u, mask, np.ones(4, np.int32))
    # two winners of equal ratio with different terms: u0 / 1 == 2 u0 / 2
    u, mask, _ = _random_case(rng, 40, 6, 8, hi=10)
    u[:, 0] = u[:, 1] = rng.integers(50, 99, 40)
    size = np.full(8, 8, np.int32)
    mask[:, 3], size[3] = [1, 0, 0, 0, 0, 0], 1
    mask[:, 5], size[5] = [1, 1, 0, 0, 0, 0], 2
    out["equal-ratios"] = (u, mask, size)
    # pairs of equal rationals with different terms: 2/1 vs 4/2 vs 6/3
    u = np.array([[2, 2, 2], [0, 0, 0], [6, 0, 0], [1, 2, 3]], np.int32)
    mask = np.array([[1, 1, 1], [0, 1, 1], [0, 0, 1]], np.int32)
    out["equal-rationals"] = (u, mask, np.array([1, 2, 3], np.int32))
    # all-zero rows, among others
    u, mask, size = _random_case(rng, 40, 11, 71)
    u[::3] = 0
    out["zero-rows"] = (u, mask, size)
    # row totals just below the guard (total * max size < 2**31)
    u, mask, size = _random_case(rng, 40, 11, 71)
    cap = (GUARD - 1) // int(size.max())
    u[:] = 0
    u[:, 0] = cap - np.arange(40, dtype=np.int32)
    u[::2, 0] = cap // 3
    u[::2, 1] = cap // 3
    u[::2, 2] = cap - 2 * (cap // 3)
    out["near-guard"] = (u, mask, size)
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_bound_ref_equals_the_jax_kernel(case):
    u, mask, size = CASES[case]
    assert int(u.sum(1).max()) * int(size.max()) < GUARD
    num, den = pb.port_bound_ref(torch.from_numpy(u), torch.from_numpy(mask),
                                 torch.from_numpy(size))
    assert num.dtype == den.dtype == torch.int32
    rnum, rden = _ref_kernel(mask, size)(u)
    got = _quotients(num.numpy(), den.numpy())
    assert np.array_equal(got, _quotients(rnum[:len(u)], rden[:len(u)]))
    # and the numpy backend's float64 closed form
    host = ((u.astype(float) @ mask.astype(float)) / size.astype(float)) \
        .max(axis=1)
    assert np.array_equal(got, host.view(np.int64))
    if case == "zero-rows":
        assert np.array_equal(num.numpy()[::3], np.zeros(14, np.int32))


def test_port_bound_wrapper_runs_the_plain_version_on_the_cpu():
    u, mask, size = (torch.from_numpy(a) for a in CASES["zero-rows"])
    before = pb.launches
    num, den = pb.port_bound(u, mask, size)
    assert pb.launches == before              # the plain version is no launch
    rnum, rden = pb.port_bound_ref(u, mask, size)
    assert torch.equal(num, rnum) and torch.equal(den, rden)
    with pytest.raises(TypeError, match="int32"):
        pb.port_bound(u.long(), mask, size)
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        pb.port_bound(u[:, :3], mask, size)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pb.port_bound(u.to("meta"), mask.to("meta"), size.to("meta"))
    e = torch.zeros((0, mask.shape[0]), dtype=torch.int32)
    assert pb.port_bound(e, mask, size)[0].shape == (0,)
