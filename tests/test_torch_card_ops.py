"""The op layer's CUDA kernels (flash attention, RMSNorm, the SSD scan)
against their plain PyTorch versions on the card.

Every test is marked ``cuda`` and skips without a GPU.  The file imports
neither jax nor the reference package, so a GPU host without jax collects
and runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_*.py

(``chip_smoke.py`` runs that command as its ``[card-tests]`` phase).
Inputs are f32 numpy arrays from ``np.random.default_rng(seed)``
(``0.5 * N(0, 1)``, ``dt = softplus(.)``, ``A = -exp(0.3 * N)``), rounded
to bf16 where a case asks for it.  Tolerances (each both atol and rtol),
the reference tests': flash attention 2e-5 f32, 2e-2 bf16; rmsnorm 1e-5
f32, 2e-2 bf16; SSD scan 1e-4 f32, 5e-2 bf16 (its passes' f32 scratch
1e-4 whatever the inputs' dtype).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import rmsnorm as p_rn
from repro_torch.kernels import ssd_scan as p_sd

FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}
RMS_TOL = {"f32": 1e-5, "bf16": 2e-2}
SSD_TOL = {"f32": 1e-4, "bf16": 5e-2}

FLASH_SHAPES = [          # tests/test_torch_ops.py's
    (1, 2, 2, 64, 64, 16),
    (2, 4, 2, 128, 128, 32),   # GQA group 2
    (1, 6, 2, 96, 96, 16),     # group 3, non-pow2 seq blocks
    (2, 2, 1, 64, 128, 8),     # cross-length (prefill-style)
    (1, 3, 1, 64, 64, 20),     # SmolLM-360M SMOKE_CONFIG heads, D = 20
    (1, 2, 1, 128, 64, 16),    # more queries than keys
]
FLASH_CASES = [(*shape, causal, dtype) for shape in FLASH_SHAPES
               for causal in (True, False) for dtype in ("f32", "bf16")]
SSD_SHAPES = [            # (b, s, h, g, p, n, chunk)
    (1, 64, 2, 1, 16, 16, 16),
    (2, 128, 4, 2, 32, 16, 32),
    (1, 96, 2, 2, 8, 8, 16),   # uneven chunk count
]
# the instantiated head dims the configs use, a ragged query count (not a
# multiple of the kernel's 64-row tile), and Sq != Sk both ways, causal and
# not: (B, Hq, Hkv, Sq, Sk, D, block)
FLASH_TILE_SHAPES = [
    (1, 4, 2, 128, 128, 80, 32),    # Zamba2-2.7B's head dim
    (1, 4, 4, 128, 128, 96, 32),    # Phi-3-mini's
    (1, 2, 1, 80, 80, 64, 16),      # ragged Sq = Sk = 80
    (2, 3, 1, 144, 144, 128, 48),   # ragged, D = 128
    (1, 2, 2, 48, 176, 64, 16),     # Sq < Sk, ragged both
    (1, 2, 1, 176, 48, 32, 16),     # Sq > Sk
]


def _normal(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype="f32"):
    """The f32 numpy array ``a`` and a torch tensor of ``dtype`` holding
    its values (rounded to nearest even for bf16)."""
    if dtype == "bf16":
        return a, torch.from_numpy(a).to(torch.bfloat16)
    return a, torch.from_numpy(a.copy())


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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,dtype", FLASH_CASES)
def test_flash_kernel_equals_plain_version_on_the_card(card, B, Hq, Hkv, Sq,
                                                       Sk, D, causal, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (_both(_normal(rng, s), dtype)[1].to(card) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    before = p_fa.launches
    got = p_fa.flash_attention_fwd(q, k, v, causal=causal, block_q=32,
                                   block_k=32)
    assert p_fa.launches == before + 1
    want = p_fa.flash_attention_ref(q, k, v, causal=causal, block_q=32,
                                    block_k=32)
    _close(got.cpu(), want.cpu(), FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32, 64), (100, 128), (7, 16), (5, 21)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_kernel_equals_plain_version_on_the_card(card, rows, d,
                                                         dtype):
    rng = np.random.default_rng(3)
    x = _both(_normal(rng, (rows, d)), dtype)[1].to(card)
    w = torch.from_numpy(1 + 0.1 * _normal(rng, (d,))).to(card)
    before = p_rn.launches
    got = p_rn.rmsnorm(x, w)
    assert p_rn.launches == before + 1
    _close(got.cpu(), p_rn.rmsnorm_ref(x, w).cpu(), RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_kernel_equals_plain_version_on_the_card(card, b, s, h, g, p, n,
                                                     chunk, dtype):
    _, t = _ssd_inputs(1, b, s, h, g, p, n, dtype)
    t = [a.to(card) for a in t]
    before = p_sd.launches
    y, st = p_sd.ssd_scan(*t, chunk)
    assert p_sd.launches == before + 1
    want_y, want_st = p_sd.ssd_scan_ref(*t, chunk)
    _close(y.cpu(), want_y.cpu(), SSD_TOL[dtype])
    _close(st.cpu(), want_st.cpu(), SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32, 64), (5, 21)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_kernel_with_bf16_weight_on_the_card(card, rows, d, dtype):
    rng = np.random.default_rng(4)
    x = _both(_normal(rng, (rows, d)), dtype)[1].to(card)
    w = torch.from_numpy(1 + 0.1 * _normal(rng, (d,))).to(card,
                                                          torch.bfloat16)
    got = p_rn.rmsnorm(x, w)
    _close(got.cpu(), p_rn.rmsnorm_ref(x, w).cpu(), RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("bf16_part", ["x", "BC"])
def test_ssd_kernel_with_mixed_dtypes_on_the_card(card, b, s, h, g, p, n,
                                                  chunk, bf16_part):
    """x in one dtype and B, C in the other, held to the bf16 tolerance."""
    _, (x, dt, A, B, C) = _ssd_inputs(1, b, s, h, g, p, n, "f32")
    if bf16_part == "x":
        x = x.to(torch.bfloat16)
    else:
        B, C = B.to(torch.bfloat16), C.to(torch.bfloat16)
    t = [a.to(card) for a in (x, dt, A, B, C)]
    y, st = p_sd.ssd_scan(*t, chunk)
    want_y, want_st = p_sd.ssd_scan_ref(*t, chunk)
    _close(y.cpu(), want_y.cpu(), SSD_TOL["bf16"])
    _close(st.cpu(), want_st.cpu(), SSD_TOL["bf16"])


# ------------------------------------------------- the SSD scan's passes
# the CPU tests' shapes; one chunk (s == chunk) with h / g > 1; widths no
# multiple of 8 or of 4 (the kernels' plain loads instead of cp.async);
# chunks no multiple of the 64-row tile, and odd (the scores read one
# element at a time); Mamba2's P = 64, N = 128 and Zamba2's N = 64 over
# several tiles.  (b, s, h, g, p, n, chunk)
SSD_PASS_SHAPES = [
    *SSD_SHAPES,
    (1, 32, 4, 1, 16, 16, 32),
    (2, 48, 6, 2, 8, 16, 48),
    (1, 60, 6, 3, 12, 20, 20),
    (1, 40, 3, 1, 5, 7, 20),
    (1, 90, 2, 1, 16, 16, 45),
    (1, 192, 2, 1, 64, 128, 96),
    (2, 512, 4, 2, 64, 128, 256),
    (1, 256, 2, 1, 64, 64, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,g,p,n,chunk", SSD_PASS_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_pass_kernels_equal_their_plain_versions_on_the_card(
        card, b, s, h, g, p, n, chunk, dtype):
    """Each of the four kernels alone against its plain version on the same
    inputs (the passes' f32 scratch at the f32 tolerance, y at its dtype's),
    then the whole call, one launch of the wrapper, against the plain
    version of the whole call."""
    _, t = _ssd_inputs(6, b, s, h, g, p, n, dtype)
    x, dt, A, B, C = (a.to(card) for a in t)
    f32 = SSD_TOL["f32"]
    cum, local = p_sd.ssd_chunk_state(x, dt, A, B, chunk)
    cum0, local0 = p_sd.ssd_chunk_state_ref(x, dt, A, B, chunk)
    _close(cum.cpu(), cum0.cpu(), f32)
    _close(local.cpu(), local0.cpu(), f32)
    mine = local0.clone()
    states, final = p_sd.ssd_state_pass(mine, cum0, chunk)
    assert states is mine                  # overwritten in place
    states0, final0 = p_sd.ssd_state_pass_ref(local0, cum0, chunk)
    _close(states.cpu(), states0.cpu(), f32)
    _close(final.cpu(), final0.cpu(), f32)
    cb = p_sd.ssd_chunk_cb(B, C, chunk)
    cb0 = p_sd.ssd_chunk_cb_ref(B, C, chunk)
    _close(torch.tril(cb).cpu(), cb0.cpu(), f32)
    y = p_sd.ssd_chunk_scan(x, dt, C, cum0, cb0, states0, chunk)
    y0 = p_sd.ssd_chunk_scan_ref(x, dt, C, cum0, cb0, states0, chunk)
    assert y.dtype == x.dtype
    _close(y.cpu(), y0.cpu(), SSD_TOL[dtype])
    before = p_sd.launches
    got_y, got_st = p_sd.ssd_scan(x, dt, A, B, C, chunk)
    assert p_sd.launches == before + 1
    want_y, want_st = p_sd.ssd_scan_ref(x, dt, A, B, C, chunk)
    _close(got_y.cpu(), want_y.cpu(), SSD_TOL[dtype])
    _close(got_st.cpu(), want_st.cpu(), SSD_TOL[dtype])


# ------------------------------------------- the redesigned kernels' tiles
@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,block", FLASH_TILE_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_kernel_tiles_on_the_card(card, B, Hq, Hkv, Sq, Sk, D, block,
                                        causal, dtype):
    """Head dims 80 and 96 (their own instances), query counts that end
    inside the kernel's 64-row tile, and Sq != Sk both ways."""
    rng = np.random.default_rng(10)
    q, k, v = (_both(_normal(rng, s), dtype)[1].to(card) for s in
               ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    kw = {"causal": causal, "block_q": block, "block_k": block}
    before = p_fa.launches
    got = p_fa.flash_attention_fwd(q, k, v, **kw)
    assert p_fa.launches == before + 1
    _close(got.cpu(), p_fa.flash_attention_ref(q, k, v, **kw).cpu(),
           FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4093, 960), (1000, 2560), (64, 4096)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_rmsnorm_kernel_register_rows_on_the_card(card, rows, d, dtype,
                                                  w_dtype):
    """Rows the register kernel holds (d = 960, SmolLM-360M: 8 packs a lane
    in f32, 4 in bf16; d = 2560, Mamba2-2.7B: 10 in bf16) and rows wider
    than its 12 packs a lane, which take the two-pass kernel (2560 in f32,
    4096 in both); more rows than the grid has warps."""
    rng = np.random.default_rng(11)
    x = _both(_normal(rng, (rows, d)), dtype)[1].to(card)
    w = _both(1 + 0.1 * _normal(rng, (d,)), w_dtype)[1].to(card)
    before = p_rn.launches
    got = p_rn.rmsnorm(x, w)
    assert p_rn.launches == before + 1
    _close(got.cpu(), p_rn.rmsnorm_ref(x, w).cpu(), RMS_TOL[dtype])


# ---------------------------------------------------------- view inputs
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_kernel_takes_views_on_the_card(card, causal, dtype):
    """q, k, v made (B, S, H, D) and passed transposed, and an offset
    slice: the same result as the plain version on the same views."""
    rng = np.random.default_rng(12)
    B, Hq, Hkv, S, D = 2, 4, 2, 96, 64
    q = _both(_normal(rng, (B, S, Hq, D)), dtype)[1].to(card)
    kv = _both(_normal(rng, (B, S + 1, 2 * Hkv, D)), dtype)[1].to(card)
    k = kv[:, 1:, :Hkv].transpose(1, 2)
    v = kv[:, 1:, Hkv:].transpose(1, 2)
    q = q.transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous())
    kw = {"causal": causal, "block_q": 32, "block_k": 32}
    before = p_fa.launches
    got = p_fa.flash_attention_fwd(q, k, v, **kw)
    assert p_fa.launches == before + 1
    _close(got.cpu(), p_fa.flash_attention_ref(q, k, v, **kw).cpu(),
           FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["offset", "strided", "transposed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_kernel_takes_views_on_the_card(card, view, dtype):
    """``x[1:]`` of an f32 (rows, 21) tensor starts 84 bytes off a 16-byte
    boundary; a strided column slice and a transpose are not contiguous."""
    rng = np.random.default_rng(13)
    if view == "offset":
        base = _both(_normal(rng, (33, 21)), dtype)[1].to(card)
        x = base[1:]
    elif view == "strided":
        x = _both(_normal(rng, (40, 128)), dtype)[1].to(card)[:, ::2]
    else:
        x = _both(_normal(rng, (64, 48)), dtype)[1].to(card).t()
    d = x.shape[-1]
    w = _both(1 + 0.1 * _normal(rng, (d + 1,)))[1].to(card)[1:]
    before = p_rn.launches
    got = p_rn.rmsnorm(x, w)
    assert p_rn.launches == before + 1
    _close(got.cpu(), p_rn.rmsnorm_ref(x, w).cpu(), RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_kernel_takes_views_on_the_card(card, dtype):
    """B and C split out of one projection (as a Mamba2 block makes them),
    x a transposed view and dt an offset slice."""
    rng = np.random.default_rng(14)
    b, s, h, g, p, n, chunk = 2, 64, 4, 2, 16, 8, 16
    x = _both(_normal(rng, (b, h, s, p)), dtype)[1].to(card).transpose(1, 2)
    dt = torch.from_numpy(np.log1p(np.exp(_normal(rng, (b * s * h + 1,)))))
    dt = dt.to(card)[1:].reshape(b, s, h)
    A = torch.from_numpy(-np.exp(_normal(rng, (h,), 0.3))).to(card)
    bc = _both(_normal(rng, (b, s, g, 2 * n)), dtype)[1].to(card)
    B, C = bc[..., :n], bc[..., n:]
    before = p_sd.launches
    y, st = p_sd.ssd_scan(x, dt, A, B, C, chunk)
    assert p_sd.launches == before + 1
    want_y, want_st = p_sd.ssd_scan_ref(x, dt, A, B, C, chunk)
    _close(y.cpu(), want_y.cpu(), SSD_TOL[dtype])
    _close(st.cpu(), want_st.cpu(), SSD_TOL[dtype])
