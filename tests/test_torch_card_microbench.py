"""The unit blockers' CUDA kernels against their plain PyTorch versions on
the card.

Every test is marked ``cuda`` and skips without a GPU.  The file imports
neither jax nor the reference package, so a GPU host without jax collects
and runs it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_*.py

Tolerances, with their reasons (as ``tests/test_torch_microbench.py``
states them): MXU rtol 1e-5 at the defaults, atol 1e-4 for an orthogonal,
non-symmetric ``b`` at 64 iterations (f32 sums taken in another order), and
1e-5 of the result's largest element at every tile the kernel takes
(``MXU_CHAIN_TOL``);
VPU rtol 1e-6 (the kernel contracts ``acc * 1.000001 + 0.5`` to a fused
multiply-add, the plain version rounds twice); SFU rtol 1e-6 (the chain
converges to a fixed point); LSU exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import microbench as pm

RTOL = {"MXU": 1e-5, "VPU": 1e-6, "SFU": 1e-6, "LSU": 0.0}
MXU_ORTH_ATOL = 1e-4
MXU_CHAIN_TOL = 1e-5   # of max |plain|: an orthogonal b keeps |acc| ~ 1


def _close(unit, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if RTOL[unit] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[unit], atol=0)


def _orthogonal(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q.astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("unit,kw", [
    ("MXU", {}), ("MXU", {"iters": 5, "tile": 48}),
    ("VPU", {}), ("VPU", {"rows": 2112}),
    ("SFU", {}), ("SFU", {"rows": 2112}),
    ("LSU", {}), ("LSU", {"rows": 1 << 17}), ("LSU", {"rows": 1000}),
])
def test_kernel_equals_plain_version_on_the_card(card, unit, kw):
    before = pm.launches[unit]
    got = pm.BLOCKERS[unit](**kw, device=card)
    torch.cuda.synchronize()
    assert pm.launches[unit] == before + 1
    want = pm.BLOCKERS[unit](**kw, device="cpu")
    _close(unit, got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_mxu_kernel_on_an_orthogonal_nonsymmetric_b(card):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    b = torch.from_numpy(_orthogonal(rng, 128))
    got = pm.mxu_chain(a.to(card), b.to(card), 64)
    want = pm.mxu_chain_ref(a.to(card), b.to(card), 64)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= MXU_ORTH_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True], ids=["contiguous", "views"])
@pytest.mark.parametrize("iters", [0, 1, 64])
@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_mxu_kernel_at_every_tile(card, tile, iters, view):
    """The chain at each tile the kernel takes (1 to 8 row blocks, so 1 to
    8 CTAs) on an orthogonal, non-symmetric ``b``: within 1e-5 of the
    plain version, relative to its largest element; with ``views``, ``a``
    transposed and ``b`` off 16-byte alignment."""
    rng = np.random.default_rng(tile + iters)
    a = rng.standard_normal((tile, tile)).astype(np.float32)
    b = _orthogonal(rng, tile)
    assert np.abs(b - b.T).max() > 0.1
    a, b = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    if view:
        a = a.t()
        b = torch.cat([torch.zeros(1, device=card), b.flatten()])[1:]
        b = b.reshape(tile, tile)
        assert not a.is_contiguous() and b.data_ptr() % 16
    before = pm.launches["MXU"]
    got = pm.mxu_chain(a, b, iters)
    torch.cuda.synchronize()
    assert pm.launches["MXU"] == before + 1
    want = pm.mxu_chain_ref(a, b, iters)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= MXU_CHAIN_TOL * want.abs().max().item(), err
    if iters == 0:
        assert torch.equal(got, a)


@pytest.mark.cuda
def test_mxu_kernel_runs_one_cta_a_row_block(card):
    assert [pm.mxu_chain_ctas(t) for t in (16, 32, 48, 64, 128)] == \
        [1, 2, 3, 4, 8]
    assert [pm.mxu_chain_ctas(t) for t in (8, 24, 144)] == [0, 0, 0]


@pytest.mark.cuda
def test_mxu_kernel_rejects_tiles_it_cannot_hold(card):
    for tile in (8, 24, 144):
        a = torch.zeros((tile, tile), device=card)
        with pytest.raises(ValueError, match="multiple of 16"):
            pm.mxu_chain(a, a, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("unit", ["MXU", "VPU", "SFU", "LSU"])
def test_kernel_takes_views_on_the_card(card, unit):
    """Each inner entry point on a transposed input and on one that starts
    off a 16-byte boundary: the plain version's result on the same view."""
    fn, ref = pm.INNER[unit]
    rng = np.random.default_rng(1)
    if unit == "MXU":
        a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
        b = torch.from_numpy(_orthogonal(rng, 64)).flatten()
        b = torch.cat([torch.zeros(1), b]).to(card)[1:].reshape(64, 64)
        views = (a.to(card).t(), b, 4)
        atol = MXU_ORTH_ATOL
    else:
        x = torch.from_numpy(rng.random((257, pm.TILE)).astype(np.float32))
        x = x.to(card)
        iters = () if unit == "LSU" else (16,)
        views = (x.flatten()[1:1 + 256 * pm.TILE].reshape(256, pm.TILE),
                 *iters)
        atol = None
    assert not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in views if isinstance(t, torch.Tensor))
    before = pm.launches[unit]
    got = fn(*views)
    torch.cuda.synchronize()
    assert pm.launches[unit] == before + 1
    want = ref(*views)
    if atol is None:
        _close(unit, got.cpu().numpy(), want.cpu().numpy())
    else:
        assert (got - want).abs().max().item() <= atol
