"""The SSD scan's passes (``repro_torch.kernels.ssd_scan``) against the
reference's Pallas kernel.

On the card :func:`ssd_scan` runs four CUDA kernels: the chunks' own
states, the state pass across chunks, the scores once a group and the chunk
outputs.  Each has a plain PyTorch version (``ssd_*_ref``), which its
wrapper runs for CPU tensors; composed, they must compute what the
reference's ``ssd_scan`` computes, here in interpret mode as
``tests/test_kernels.py`` runs it.  Inputs are f32 numpy arrays from
``np.random.default_rng(seed)`` (``0.5 * N(0, 1)``, ``dt = softplus(.)``,
``A = -exp(0.3 * N)``); for bf16 both frameworks round the same arrays to
nearest even.  Tolerances (each both atol and rtol), the reference tests':
1e-4 f32, 5e-2 bf16.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_card_ops.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.ssd_scan import ssd_scan as r_ssd
from repro_torch.kernels import ssd_scan as p_sd

SSD_TOL = {"f32": 1e-4, "bf16": 5e-2}
SHAPES = [                 # (b, s, h, g, p, n, chunk)
    (1, 64, 2, 1, 16, 16, 16),     # tests/test_torch_ops.py's SSD_SHAPES
    (2, 128, 4, 2, 32, 16, 32),
    (1, 96, 2, 2, 8, 8, 16),
    (1, 32, 4, 1, 16, 16, 32),     # one chunk (s == chunk), h / g = 4
    (2, 48, 6, 2, 8, 16, 48),      # one chunk, h / g = 3
    (1, 60, 6, 3, 12, 20, 20),     # h / g = 2, widths no multiple of 8
]


def _normal(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, b, s, h, g, p, n, dtype="f32"):
    """The same values as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    arrays = [_normal(rng, (b, s, h, p)),
              np.log1p(np.exp(_normal(rng, (b, s, h)))),       # softplus
              -np.exp(_normal(rng, (h,), 0.3)),
              _normal(rng, (b, s, g, n)), _normal(rng, (b, s, g, n))]
    low = (0, 3, 4) if dtype == "bf16" else ()
    j = [jnp.asarray(a).astype(jnp.bfloat16) if i in low else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a.copy()).to(torch.bfloat16) if i in low
         else torch.from_numpy(a.copy()) for i, a in enumerate(arrays)]
    return j, t


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _passes(x, dt, A, B, C, chunk):
    """The four passes' wrappers in the order ssd_scan runs them."""
    cum, local = p_sd.ssd_chunk_state(x, dt, A, B, chunk)
    states, final = p_sd.ssd_state_pass(local, cum, chunk)
    cb = p_sd.ssd_chunk_cb(B, C, chunk)
    return p_sd.ssd_chunk_scan(x, dt, C, cum, cb, states, chunk), final


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_composed_passes_match_the_reference_kernel(b, s, h, g, p, n, chunk,
                                                    dtype):
    j, t = _inputs(1, b, s, h, g, p, n, dtype)
    want_y, want_st = r_ssd(*j, chunk, interpret=True)
    before = p_sd.launches
    y, st = _passes(*t, chunk)
    assert p_sd.launches == before          # CPU tensors: no launch
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    _close(y, want_y, SSD_TOL[dtype])
    _close(st, want_st, SSD_TOL[dtype])
    # and the whole call's plain version, which the CPU path runs
    y2, st2 = p_sd.ssd_scan(*t, chunk)
    _close(y, y2, SSD_TOL[dtype])
    _close(st, st2, SSD_TOL[dtype])


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SHAPES)
def test_state_pass_gives_the_state_at_every_chunk_boundary(b, s, h, g, p, n,
                                                            chunk):
    """The state entering chunk c is the reference kernel's final state
    over the first c chunks; the final state, its state over all of them."""
    j, t = _inputs(2, b, s, h, g, p, n)
    x, dt, A, B, _ = t
    cum, local = p_sd.ssd_chunk_state_ref(x, dt, A, B, chunk)
    states, final = p_sd.ssd_state_pass(local, cum, chunk)
    assert states is local                   # overwritten, as on the card
    nc = s // chunk
    assert states.shape == (b, h, nc, p, n)
    assert not states[:, :, 0].any()         # nothing enters chunk 0
    for c in range(1, nc + 1):
        prefix = [a[:, :c * chunk] if a.ndim > 1 else a for a in j]
        want = r_ssd(*prefix, chunk, interpret=True)[1]
        got = states[:, :, c] if c < nc else final
        _close(got, want, SSD_TOL["f32"])


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SHAPES[:3])
def test_passes_have_the_kernels_layouts(b, s, h, g, p, n, chunk):
    """cum restarts at every chunk, the scores are 0 above the diagonal,
    and every scratch tensor is f32 whatever the inputs' dtype."""
    _, t = _inputs(3, b, s, h, g, p, n, "bf16")
    x, dt, A, B, C = t
    nc = s // chunk
    cum, local = p_sd.ssd_chunk_state(x, dt, A, B, chunk)
    assert cum.shape == (b, h, s) and local.shape == (b, h, nc, p, n)
    first = (dt[:, :chunk] * A).float().cumsum(1).movedim(2, 1)
    torch.testing.assert_close(cum[..., :chunk], first, atol=1e-6, rtol=1e-6)
    second = (dt[:, chunk:2 * chunk] * A).float().cumsum(1).movedim(2, 1)
    torch.testing.assert_close(cum[..., chunk:2 * chunk], second, atol=1e-6,
                               rtol=1e-6)
    cb = p_sd.ssd_chunk_cb(B, C, chunk)
    assert cb.shape == (b, g, nc, chunk, chunk)
    assert not torch.triu(cb, diagonal=1).any()
    torch.testing.assert_close(
        cb[0, 0, 0], torch.tril(C[0, :chunk, 0].float()
                                @ B[0, :chunk, 0].float().T))
    assert all(v.dtype == torch.float32 for v in (cum, local, cb))


def test_f64_inputs_run_the_plain_version_in_f64():
    """The card's accuracy check holds kernel and f32 plain version against
    the plain version on f64 copies: that version computes in f64 and
    agrees with the f32 one to the f32 tolerance."""
    _, t = _inputs(4, 2, 64, 4, 2, 16, 16)
    y32, st32 = p_sd.ssd_scan_ref(*t, 16)
    y64, st64 = p_sd.ssd_scan_ref(*(a.double() for a in t), 16)
    assert y64.dtype == st64.dtype == torch.float64
    assert y32.dtype == st32.dtype == torch.float32
    _close(y32, y64, SSD_TOL["f32"])
    _close(st32, st64, SSD_TOL["f32"])
    y, st = _passes(*(a.double() for a in t), 16)
    assert y.dtype == st.dtype == torch.float64
    torch.testing.assert_close(y, y64)
    torch.testing.assert_close(st, st64)


def test_pass_wrappers_check_their_shapes():
    _, (x, dt, A, B, C) = _inputs(5, 1, 24, 2, 1, 4, 4)
    with pytest.raises(ValueError, match="must divide"):
        p_sd.ssd_chunk_state(x, dt, A, B, 16)
    cum, local = p_sd.ssd_chunk_state(x, dt, A, B, 8)
    with pytest.raises(ValueError, match="ssd_state_pass"):
        p_sd.ssd_state_pass(local, cum, 6)
    with pytest.raises(ValueError, match="ssd_chunk_cb"):
        p_sd.ssd_chunk_cb(B, C[:, :, :, :3], 8)
    states, _ = p_sd.ssd_state_pass(local, cum, 8)
    cb = p_sd.ssd_chunk_cb(B, C, 8)
    with pytest.raises(ValueError, match="ssd_chunk_scan"):
        p_sd.ssd_chunk_scan(x, dt, C, cum, cb[..., :4], states, 8)
    with pytest.raises(ValueError, match="ssd_chunk_scan"):
        p_sd.ssd_chunk_scan(x, dt[:, :8], C, cum, cb, states, 8)


def test_pass_wrappers_raise_on_cuda_tensors_they_cannot_take(monkeypatch):
    """What the kernels do not take raises on a CUDA tensor before any
    launch; a call they take goes to the kernel library (which cannot build
    here), never to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with FakeTensorMode():
        x, dt, A, B = (torch.empty(s, device="cuda") for s in
                       ((1, 32, 2, 128), (1, 32, 2), (2,), (1, 32, 1, 16)))
        wide_B = torch.empty((1, 32, 1, 256), device="cuda")
        x16 = torch.empty((1, 32, 2, 16), device="cuda")
        B64 = torch.empty((1, 32, 1, 16), dtype=torch.float64, device="cuda")
    before = p_sd.launches
    with pytest.raises(ValueError, match="p <= 64"):
        p_sd.ssd_chunk_state(x, dt, A, B, 16)
    with pytest.raises(ValueError, match="n <= 128"):
        p_sd.ssd_chunk_cb(wide_B, wide_B, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        p_sd.ssd_chunk_cb(B64, B64, 16)
    with pytest.raises((RuntimeError, OSError)):
        p_sd.ssd_chunk_state(x16, dt, A, B, 16)
    assert p_sd.launches == before
