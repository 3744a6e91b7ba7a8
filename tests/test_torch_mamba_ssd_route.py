"""The prefill block's SSD route (``models/mamba.py:ssd_route``), on the CPU.

* The predicate keeps the plain scan (``ssd_chunked_sharded``) for CPU
  tensors, fake CUDA tensors (the dry run's), operands that need a gradient
  under grad mode and an enabled mesh axis, without asking the kernel
  library.
* With the device check (``_card_tensor``) stood in for, it takes the
  kernel, also for operands that require grad under ``torch.no_grad``; and
  a shape or dtype the kernel does not take (``p > 64``, ``n > 128``, x or
  B/C in a dtype it does not read, a chunk whose passes do not fit shared
  memory) raises from the kernel's wrapper on CUDA operands, before any
  launch, as ``test_torch_ssd.py`` checks the pass wrappers.
* With the kernel's call (``kernels/ssd_scan.py:ssd_scan``) replaced by its
  plain version ``ssd_scan_ref``, ``MambaLM.prefill`` at the smoke config
  goes through the route once a layer, and its logits and ``ssm``/``conv``
  state lie within ``TOL`` of the ``ssd_chunked`` path's, at a length the
  chunk (16) divides and at lengths it does not (the tail zero-padded).
  ``TOL`` (largest |difference| over the largest |value|): f32 compute
  1e-5, the two scans' f32 sums in other orders (measured <= 3.4e-7 at
  these sizes); bf16 compute 2**-7, two bf16 roundings of an f32 value
  that the order of its sums moved.
* A training step reaches no kernel call, whatever the device check says:
  its operands need a gradient in the forward and in the recompute.
* The ``mamba.ssd`` span carries ``route=``.

Imports no jax."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import load_config
from repro_torch.kernels import ssd_scan as p_sd
from repro_torch.models import mamba as M
from repro_torch.models.model import build_model
from repro_torch.models.sharding import SINGLE, MeshAxes
from repro_torch.obs import tracer as obs
from repro_torch.optim import adamw
from repro_torch.train.serve import make_prefill
from repro_torch.train.train_loop import make_train_step

TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
NO_AXES = SINGLE
ON_AXES = MeshAxes(batch=("data",), model="model", enabled=True)


def _operands(seed=0, b=1, s=32, h=2, p=16, g=1, n=16, dtype=torch.float32,
              device="cpu"):
    g_ = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g_).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g_))
    A = -torch.exp(0.3 * torch.randn((h,), generator=g_))
    B = torch.randn((b, s, g, n), generator=g_).to(dtype)
    C = torch.randn((b, s, g, n), generator=g_).to(dtype)
    return [t.to(device) for t in (x, dt, A, B, C)]


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library is never asked (it cannot build here)."""
    def refuse(*a):
        raise AssertionError("the kernel library was asked")

    monkeypatch.setattr(p_sd.LIBRARY, "load", refuse)


@pytest.fixture
def card_stand_in(monkeypatch):
    """Every operand passes for a card tensor."""
    monkeypatch.setattr(M, "_card_tensor", lambda t: True)


def _kernel_stand_in(monkeypatch):
    """Every operand passes for a card tensor and the kernel's call is its
    plain version; returns the list of the calls' x shapes."""
    calls = []

    def plain(*args):
        calls.append(tuple(args[0].shape))
        return p_sd.ssd_scan_ref(*args)

    monkeypatch.setattr(M, "_card_tensor", lambda t: True)
    monkeypatch.setattr(p_sd, "ssd_scan", plain)
    return calls


def test_cpu_operands_take_the_plain_scan(no_library):
    ops = _operands()
    assert M.ssd_route(*ops, NO_AXES) == "plain"


def test_fake_cuda_operands_take_the_plain_scan(monkeypatch, no_library):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with FakeTensorMode():
        ops = [torch.empty(t.shape, device="cuda") for t in _operands()]
        assert all(t.is_cuda for t in ops)
        assert M.ssd_route(*ops, NO_AXES) == "plain"


@pytest.mark.parametrize("case", ["grad_x", "grad_A", "grad_B", "axes"])
def test_what_the_kernel_cannot_take_keeps_the_plain_scan(
        monkeypatch, no_library, case):
    """A gradient (the kernel has no backward) or a mesh."""
    monkeypatch.setattr(M, "_card_tensor", lambda t: True)
    x, dt, A, B, C = _operands()
    if case.startswith("grad_"):
        {"grad_x": x, "grad_A": A, "grad_B": B}[case].requires_grad_(True)
    axes = ON_AXES if case == "axes" else NO_AXES
    assert axes.enabled == (case == "axes")
    assert M.ssd_route(x, dt, A, B, C, axes) == "plain"


class _Library:
    """The kernel library's shared-memory check alone: a chunk of at most
    256 steps fits."""

    @staticmethod
    def ssd_scan_fits(p, n, q):
        return int(q <= 256)


@pytest.mark.parametrize("case,error,match", [
    ("p_65", ValueError, "p <= 64"), ("n_256", ValueError, "n <= 128"),
    ("x_f64", TypeError, "float32 or bfloat16"),
    ("x_f16", TypeError, "float32 or bfloat16"),
    ("bc_mixed", TypeError, "float32 or bfloat16"),
    ("chunk_512", ValueError, "shared memory")])
def test_what_the_kernel_cannot_fit_raises_on_the_card(
        monkeypatch, card_stand_in, case, error, match):
    """The route takes the kernel on CUDA operands whatever their shapes
    and dtypes; the wrapper raises on what it cannot take, before any
    launch (fake CUDA tensors stand in for the card's)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(p_sd.LIBRARY, "load", lambda: (_Library, False))
    s, chunk = (512, 512) if case == "chunk_512" else (32, 16)
    shape = {"p_65": {"p": 65}, "n_256": {"n": 256}}.get(case, {})
    x_dtype = {"x_f64": torch.float64, "x_f16": torch.float16}.get(
        case, torch.float32)
    c_dtype = torch.bfloat16 if case == "bc_mixed" else torch.float32
    with FakeTensorMode():
        x, dt, A, B, C = (
            torch.empty(t.shape, dtype=d, device="cuda") for t, d in zip(
                _operands(s=s, **shape),
                (x_dtype, torch.float32, torch.float32, torch.float32,
                 c_dtype)))
    assert M.ssd_route(x, dt, A, B, C, NO_AXES) == "kernel"
    before = p_sd.launches
    with pytest.raises(error, match=match):
        M.ssd_kernel(x, dt, A, B, C, chunk)
    assert p_sd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [32, 40, 8, 256])
def test_with_the_device_check_stood_in_for_the_kernel_is_taken(
        card_stand_in, dtype, s):
    ops = _operands(s=s, p=64, n=128, dtype=dtype)
    assert M.ssd_route(*ops, NO_AXES) == "kernel"


def test_operands_that_require_grad_take_the_kernel_without_grad_mode(
        card_stand_in):
    x, dt, A, B, C = _operands()
    A.requires_grad_(True)
    assert M.ssd_route(x, dt, A, B, C, NO_AXES) == "plain"
    with torch.no_grad():
        assert M.ssd_route(x, dt, A, B, C, NO_AXES) == "kernel"


@pytest.mark.parametrize("s", [32, 40, 7])
def test_ssd_kernel_pads_the_tail_as_ssd_chunked_does(s):
    ops = _operands(seed=3, b=2, s=s, h=4, g=2)
    y0, st0 = M.ssd_chunked(*ops, 16)
    y1, st1 = M.ssd_kernel(*ops, 16)
    assert y1.shape == y0.shape and st1.shape == st0.shape
    for a, b in ((y1, y0), (st1, st0)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def _model(compute_dtype, remat="full"):
    cfg = load_config("mamba2_2_7b", smoke=True).replace(
        compute_dtype=compute_dtype, remat=remat)
    return build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def _tokens(s, b=2):
    return torch.randint(0, 512, (b, s), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [32, 40, 9])
def test_routed_prefill_matches_the_plain_scan(monkeypatch, compute_dtype,
                                               s):
    model = _model(compute_dtype)
    tokens = {"tokens": _tokens(s)}
    want_logits, want = model.prefill(tokens)
    calls = _kernel_stand_in(monkeypatch)
    logits, got = model.prefill(tokens)
    cfg = model.cfg
    q = min(cfg.ssm_chunk, s)
    padded = (2, -(-s // q) * q, cfg.ssm_heads, cfg.ssm_headdim)
    assert calls == [padded] * cfg.num_layers
    tol = TOL[compute_dtype]
    _close(logits, want_logits, tol)
    for k in ("ssm", "conv"):
        _close(got[k], want[k], tol)
    assert torch.equal(got["pos"], want["pos"])


@pytest.mark.parametrize("remat", ["full", "none"])
def test_a_training_step_reaches_no_kernel_call(monkeypatch, remat):
    kernel_calls = _kernel_stand_in(monkeypatch)
    model = _model(torch.float32, remat)
    step = make_train_step(model, adamw.AdamWConfig(), 2)
    batch = {"tokens": _tokens(32, 4), "labels": _tokens(32, 4)}
    _, _, metrics = step(model, adamw.init_state(model), batch)
    assert torch.isfinite(metrics["loss"])
    assert kernel_calls == []


def _ssd_routes(run):
    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        run()
        return [e["args"]["route"] for e in obs.get_tracer().events()
                if e["name"] == "mamba.ssd"]
    finally:
        obs.set_tracer(prev)


def test_the_ssd_span_carries_its_route(monkeypatch):
    model = _model(torch.float32)
    prefill = make_prefill(model)
    L = model.cfg.num_layers
    tokens = {"tokens": _tokens(32)}
    assert _ssd_routes(lambda: prefill(tokens)) == ["plain"] * L
    _kernel_stand_in(monkeypatch)
    assert _ssd_routes(lambda: prefill(tokens)) == ["kernel"] * L
    step = make_train_step(model, adamw.AdamWConfig(), 1)
    batch = {"tokens": _tokens(32), "labels": _tokens(32)}
    routes = _ssd_routes(lambda: step(model, adamw.init_state(model), batch))
    assert routes == ["plain"] * (2 * L)     # the forward and the recompute
