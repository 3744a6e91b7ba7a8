"""The port's op layer (``repro_torch.kernels``: flash attention, RMSNorm,
the SSD scan, their oracles and ``ops``) against the reference's.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode (``interpret=True``, or
``repro.kernels.ops``, which interprets off a TPU), as
``tests/test_kernels.py`` runs it.  Inputs are f32 numpy arrays from
``np.random.default_rng(seed)`` (``0.5 * N(0, 1)``, ``dt = softplus(.)``,
``A = -exp(0.3 * N)``, as ``tests/test_kernels.py`` makes them); for bf16
both frameworks round the same f32 arrays to nearest even, so the inputs
are identical.  Tolerances (each both atol and rtol), the reference tests':

* flash attention forward: 2e-5 f32, 2e-2 bf16;
* ``ops.flash_attention`` gradients: 1e-4;
* rmsnorm: 1e-5 f32, 2e-2 bf16;
* SSD scan: 1e-4 f32, 5e-2 bf16; chunked SSD against the sequential
  recurrence: 1e-3; the port's ``ssd_chunked``/``ssd_step`` against the
  reference's: 1e-5 (the same ops in f32, summed in another order).

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_card_ops.py``, which imports no jax, so that
the card's host collects it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_*.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.flash_attention import flash_attention_fwd as r_flash
from repro.kernels.rmsnorm import rmsnorm as r_rmsnorm
from repro.kernels.ssd_scan import ssd_scan as r_ssd
from repro.models import mamba as r_mamba
from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rmsnorm as p_rn
from repro_torch.kernels import ssd_scan as p_sd
from repro_torch.models import mamba as p_mamba

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = 1e-4
RMS_TOL = {"f32": 1e-5, "bf16": 2e-2}
SSD_TOL = {"f32": 1e-4, "bf16": 5e-2}
SSD_SEQ_TOL = 1e-3
MODEL_TOL = 1e-5

FLASH_SHAPES = [          # tests/test_kernels.py's four, and two more
    (1, 2, 2, 64, 64, 16),
    (2, 4, 2, 128, 128, 32),   # GQA group 2
    (1, 6, 2, 96, 96, 16),     # group 3, non-pow2 seq blocks
    (2, 2, 1, 64, 128, 8),     # cross-length (prefill-style)
    (1, 3, 1, 64, 64, 20),     # SmolLM-360M SMOKE_CONFIG heads, D = 20
    (1, 2, 1, 128, 64, 16),    # more queries than keys
]
# causal cross-length too: both packages align the causal mask top-left
FLASH_CASES = [(*shape, causal, dtype) for shape in FLASH_SHAPES
               for causal in (True, False) for dtype in ("f32", "bf16")]
SSD_SHAPES = [            # (b, s, h, g, p, n, chunk), tests/test_kernels.py's
    (1, 64, 2, 1, 16, 16, 16),
    (2, 128, 4, 2, 32, 16, 32),
    (1, 96, 2, 2, 8, 8, 16),   # uneven chunk count
]


def _normal(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype="f32"):
    """The f32 numpy array ``a`` as a JAX array and a torch tensor of
    ``dtype``, with identical values."""
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _ssd_inputs(seed, b, s, h, g, p, n, dtype="f32"):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, s, h))))        # softplus
    A = -np.exp(_normal(rng, (h,), 0.3))
    B = _normal(rng, (b, s, g, n))
    C = _normal(rng, (b, s, g, n))
    j, t = zip(_both(x, dtype), _both(dt), _both(A), _both(B, dtype),
               _both(C, dtype))
    return j, t


def test_bf16_inputs_are_identical_in_both_frameworks():
    a = _normal(np.random.default_rng(0), (64, 33))
    j, t = _both(a, "bf16")
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.float().numpy())


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,dtype", FLASH_CASES)
def test_flash_attention_matches_reference(B, Hq, Hkv, Sq, Sk, D, causal,
                                           dtype):
    rng = np.random.default_rng(0)
    arrays = [_normal(rng, (B, Hq, Sq, D)), _normal(rng, (B, Hkv, Sk, D)),
              _normal(rng, (B, Hkv, Sk, D))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    want = r_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                   interpret=True)
    before = p_fa.launches
    got = p_fa.flash_attention_fwd(tq, tk, tv, causal=causal, block_q=32,
                                   block_k=32)
    assert p_fa.launches == before     # a CPU tensor takes the plain version
    assert got.dtype == tq.dtype
    _close(got, want, FLASH_TOL[dtype])
    # the port's oracle agrees with the reference's oracle too
    _close(p_ref.reference_attention(tq, tk, tv, causal=causal),
           r_ref.reference_attention(jq, jk, jv, causal=causal),
           FLASH_TOL[dtype])


@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 16), (1, 4, 2, 32, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_gradients_match_reference(shape, causal):
    B, Hq, Hkv, S, D = shape
    rng = np.random.default_rng(4)
    arrays = [_normal(rng, (B, Hq, S, D)), _normal(rng, (B, Hkv, S, D)),
              _normal(rng, (B, Hkv, S, D))]
    jax_in = [jnp.asarray(a) for a in arrays]

    def f(q, k, v):
        return jnp.sum(r_ops.flash_attention(q, k, v, causal, 16, 16) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*jax_in)
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = p_ops.flash_attention(*leaves, causal, 16, 16)
    _close(out, r_ops.flash_attention(*jax_in, causal, 16, 16),
           FLASH_TOL["f32"])
    (out ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w, GRAD_TOL)


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("rows,d", [(32, 64), (100, 128), (7, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference(rows, d, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _both(_normal(rng, (rows, d)), dtype)
    jw, tw = _both(1 + 0.1 * _normal(rng, (d,)))
    before = p_rn.launches
    got = p_rn.rmsnorm(tx, tw)
    assert p_rn.launches == before
    assert got.dtype == tx.dtype
    want = r_rmsnorm(jx, jw, interpret=True, block_rows=16)
    _close(got, want, RMS_TOL[dtype])
    _close(p_ops.rmsnorm(tx, tw), r_ops.rmsnorm(jx, jw), RMS_TOL[dtype])
    _close(p_ref.reference_rmsnorm(tx, tw), r_ref.reference_rmsnorm(jx, jw),
           RMS_TOL[dtype])


# --------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_matches_reference(b, s, h, g, p, n, chunk, dtype):
    j, t = _ssd_inputs(1, b, s, h, g, p, n, dtype)
    want_y, want_st = r_ssd(*j, chunk, interpret=True)
    before = p_sd.launches
    y, st = p_sd.ssd_scan(*t, chunk)
    assert p_sd.launches == before
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    _close(y, want_y, SSD_TOL[dtype])
    _close(st, want_st, SSD_TOL[dtype])
    # the port's chunked oracle, against the reference's
    ry, rst = r_ref.reference_ssd(*j, chunk)
    py, pst = p_ref.reference_ssd(*t, chunk)
    _close(py, ry, SSD_TOL[dtype])
    _close(pst, rst, SSD_TOL[dtype])


def test_ops_ssd_scan_matches_reference_default_chunk():
    j, t = _ssd_inputs(5, 2, 64, 4, 2, 16, 8)
    want_y, want_st = r_ops.ssd_scan(*j)
    y, st = p_ops.ssd_scan(*t)
    _close(y, want_y, SSD_TOL["f32"])
    _close(st, want_st, SSD_TOL["f32"])


def test_reference_ssd_equals_sequential():
    """The chunked SSD equals the plain recurrence (the state-space-duality
    identity), in the port, and the port's recurrence equals the
    reference's."""
    j, t = _ssd_inputs(2, 2, 64, 4, 2, 8, 16)
    y1, st1 = p_ref.reference_ssd(*t, chunk=16)
    y2, st2 = p_ref.reference_ssd_sequential(*t)
    _close(y1, y2, SSD_SEQ_TOL)
    _close(st1, st2, SSD_SEQ_TOL)
    ry, rst = r_ref.reference_ssd_sequential(*j)
    _close(y2, ry, MODEL_TOL)
    _close(st2, rst, MODEL_TOL)


@pytest.mark.parametrize("s,chunk,with_state", [(64, 16, False),
                                                (50, 16, False),
                                                (37, 8, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    """Including a length the chunk does not divide (zero-padded tail)."""
    b, h, g, p, n = 2, 4, 2, 8, 16
    j, t = _ssd_inputs(3, b, s, h, g, p, n)
    init = _normal(np.random.default_rng(6), (b, h, p, n))
    ji, ti = _both(init) if with_state else (None, None)
    ry, rst = r_mamba.ssd_chunked(*j, chunk, initial_state=ji)
    py, pst = p_mamba.ssd_chunked(*t, chunk, initial_state=ti)
    assert py.shape == (b, s, h, p)
    _close(py, ry, MODEL_TOL)
    _close(pst, rst, MODEL_TOL)


def test_ssd_step_and_segsum_match_reference():
    b, h, g, p, n = 2, 4, 2, 8, 16
    rng = np.random.default_rng(7)
    arrays = [_normal(rng, (b, h, p, n)), _normal(rng, (b, h, p)),
              np.log1p(np.exp(_normal(rng, (b, h)))),
              -np.exp(_normal(rng, (h,), 0.3)), _normal(rng, (b, g, n)),
              _normal(rng, (b, g, n))]
    j, t = zip(*(_both(a) for a in arrays))
    ry, rst = r_mamba.ssd_step(*j)
    py, pst = p_mamba.ssd_step(*t)
    _close(py, ry, MODEL_TOL)
    _close(pst, rst, MODEL_TOL)
    x = _normal(rng, (3, 12))
    want = np.asarray(r_mamba.segsum(jnp.asarray(x)))
    got = p_mamba.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=MODEL_TOL,
                               rtol=MODEL_TOL)


# ------------------------------------------------------------ the wrappers
def test_forward_only_ops_raise_on_backward():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_normal(rng, (4, 16))).requires_grad_()
    w = torch.ones(16)
    with pytest.raises(RuntimeError, match="rmsnorm is forward-only"):
        p_ops.rmsnorm(x, w).sum().backward()
    _, t = _ssd_inputs(9, 1, 16, 2, 1, 4, 4)
    xs = t[0].clone().requires_grad_()
    y, st = p_ops.ssd_scan(xs, *t[1:], 8)
    with pytest.raises(RuntimeError, match="ssd_scan is forward-only"):
        (y.sum() + st.sum()).backward()
    # without inputs that need a gradient, the outputs need none
    assert not p_ops.rmsnorm(x.detach(), w).requires_grad


def test_wrappers_keep_the_reference_checks():
    q = torch.zeros(1, 4, 64, 16)
    kv = torch.zeros(1, 3, 64, 16)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        p_fa.flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="multiples of their blocks"):
        p_fa.flash_attention_fwd(q, q, q, block_q=48)
    with pytest.raises(ValueError, match="cuda or cpu"):
        p_fa.flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))
    _, t = _ssd_inputs(9, 1, 24, 2, 1, 4, 4)
    with pytest.raises(ValueError, match="must divide"):
        p_sd.ssd_scan(*t, 16)
    with pytest.raises(ValueError, match=r"w \(d,\)"):
        p_rn.rmsnorm(torch.zeros(4, 8), torch.ones(9))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        p_rn.rmsnorm(torch.zeros(4, 8, dtype=torch.float64), torch.ones(8))


def _fake_cuda(*shapes, dtype=torch.float32):
    with FakeTensorMode():
        return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


def test_card_limits_raise_before_any_launch(monkeypatch):
    """What the kernels do not take raises on a CUDA tensor, before any
    launch, and a call the kernels do take goes to the kernel library (which
    cannot build here) rather than to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = (p_fa.launches, p_rn.launches, p_sd.launches)
    q, kv = _fake_cuda((1, 2, 64, 160), (1, 1, 64, 160))
    with pytest.raises(ValueError, match="D <= 128"):
        p_fa.flash_attention_fwd(q, kv, kv)
    q, kv = _fake_cuda((1, 2, 64, 64), (1, 1, 64, 64))
    kb, = _fake_cuda((1, 1, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        p_fa.flash_attention_fwd(q, kb, kb)
    # a view is copied (in the fake tensors' mode) and goes on to the kernel
    # library, which cannot build here
    with q.fake_mode, pytest.raises((RuntimeError, OSError), match="nvcc"):
        p_fa.flash_attention_fwd(q.transpose(2, 3), kv, kv)
    x, dt, A, B = _fake_cuda((1, 32, 2, 128), (1, 32, 2), (2,),
                             (1, 32, 1, 16))
    with pytest.raises(ValueError, match="p <= 64"):
        p_sd.ssd_scan(x, dt, A, B, B, 16)
    with pytest.raises((RuntimeError, OSError)):
        p_fa.flash_attention_fwd(q, kv, kv)
    x, w = _fake_cuda((4, 16), (16,))
    with pytest.raises((RuntimeError, OSError)):
        p_rn.rmsnorm(x, w)
    assert (p_fa.launches, p_rn.launches, p_sd.launches) == before
