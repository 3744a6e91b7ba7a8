"""The prefill block's SSD route on the card: ``mamba_block`` with its scan
through ``kernels/ssd_scan.py:ssd_scan`` against the same block through
``ssd_chunked``.

Every test is marked ``cuda`` and skips without a GPU.  The file imports
neither jax nor the reference package, so a GPU host without jax collects
and runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_ssd_route.py

(``chip_smoke.py``'s ``[card-tests]`` phase runs every
``tests/test_torch_card_*.py``).  TF32 is off for PyTorch's matmuls, so the
plain scan is f32 throughout; the kernel's f32 path is 3xTF32.  ``TOL``
(largest |difference| over the largest |value|, for the block's output,
``y`` and the final SSM state): f32 compute 1e-4, the card's SSD tolerance
of ``tests/test_torch_card_ops.py``; bf16 compute 2**-6, a bf16 rounding or
two moved by the scans' f32 differences.  Weights from
``torch.Generator(seed 0)`` on the card; inputs ``N(0, 1)``.
"""
import pytest
import torch

from repro_torch.configs.base import load_config
from repro_torch.kernels import ssd_scan as p_sd
from repro_torch.models import mamba as M
from repro_torch.models.model import build_model
from repro_torch.models.sharding import SINGLE
from repro_torch.obs import tracer as obs
from repro_torch.optim import adamw
from repro_torch.train.serve import make_prefill
from repro_torch.train.train_loop import make_train_step

TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel's half of a route "
                    "check)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= tol, (what, err)


def _both_routes(monkeypatch, run):
    """``run()`` through the route the block chooses, then through the
    plain scan, with the launches counted on the first."""
    before = p_sd.launches
    got = run()
    launches = p_sd.launches - before
    with monkeypatch.context() as m:
        m.setattr(M, "ssd_route", lambda *a: "plain")
        want = run()
    return got, want, launches


def _block(monkeypatch, cfg, card, S, B=1):
    gen = torch.Generator(device=card).manual_seed(0)
    p = M.mamba_params(gen, cfg)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=card).to(cfg.compute_dtype)
    run = lambda: M.mamba_block(x, p, cfg, SINGLE, 0)    # noqa: E731
    return _both_routes(monkeypatch, run)


def _check_block(got, want, tol):
    (out, (ssm, conv)), (out0, (ssm0, conv0)) = got, want
    _close(out, out0, tol, "out")
    _close(ssm, ssm0, tol, "ssm")
    assert torch.equal(conv, conv0)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [64, 72, 9])
def test_routed_block_equals_the_plain_scan_at_the_smoke_config(
        card, monkeypatch, compute_dtype, S):
    cfg = load_config("mamba2_2_7b", smoke=True).replace(
        compute_dtype=compute_dtype)
    with torch.no_grad():
        got, want, launches = _block(monkeypatch, cfg, card, S, B=2)
    assert launches == 1
    _check_block(got, want, TOL[compute_dtype])


@pytest.mark.cuda
def test_routed_block_equals_the_plain_scan_at_full_width(card, monkeypatch):
    """One Mamba2-2.7B layer at the prefill cell's (1, 4096, 80, 64, 128,
    chunk 256), f32 compute; and the scan alone, y and final state."""
    cfg = load_config("mamba2_2_7b").replace(compute_dtype=torch.float32,
                                             num_layers=1)
    with torch.no_grad():
        got, want, launches = _block(monkeypatch, cfg, card, 4096)
    assert launches == 1
    _check_block(got, want, TOL[torch.float32])
    del got, want
    gen = torch.Generator(device=card).manual_seed(1)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = torch.randn((1, 4096, h, p), generator=gen, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn((1, 4096, h), generator=gen, device=card) - 2.0)
    A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=card))
    B, C = (torch.randn((1, 4096, 1, n), generator=gen, device=card)
            for _ in range(2))
    assert M.ssd_route(x, dt, A, B, C, SINGLE) == "kernel"
    y, st = M.ssd_kernel(x, dt, A, B, C, cfg.ssm_chunk)
    y0, st0 = M.ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk)
    _close(y, y0, TOL[torch.float32], "y")
    _close(st, st0, TOL[torch.float32], "state")


def _model(card, remat="full"):
    cfg = load_config("mamba2_2_7b", smoke=True).replace(remat=remat)
    return build_model(cfg, device=card).init(
        torch.Generator(device=card).manual_seed(0))


def _routes(run):
    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        before = p_sd.launches
        run()
        torch.cuda.synchronize()
        return ([e["args"]["route"] for e in obs.get_tracer().events()
                 if e["name"] == "mamba.ssd"], p_sd.launches - before)
    finally:
        obs.set_tracer(prev)


@pytest.mark.cuda
def test_prefill_launches_the_kernel_once_a_layer(card):
    model = _model(card)
    L = model.cfg.num_layers
    tokens = torch.randint(0, 512, (2, 40), device=card, dtype=torch.int32)
    prefill = make_prefill(model)
    assert _routes(lambda: prefill({"tokens": tokens})) == (["kernel"] * L, L)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "none"])
def test_a_training_step_launches_no_kernel(card, remat):
    model = _model(card, remat)
    L = model.cfg.num_layers
    step = make_train_step(model, adamw.AdamWConfig(), 1)
    tokens = torch.randint(0, 512, (2, 32), device=card, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    state = adamw.init_state(model)
    calls = 2 * L if remat == "full" else L   # the recompute enters again
    assert _routes(lambda: step(model, state, batch)) == (["plain"] * calls,
                                                          0)
