"""The port's unit blockers against the reference's Pallas kernels.

On the CPU each port blocker runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode.  Inputs are made with numpy from
a seed and handed to both.  Tolerances, with their reasons:

* MXU: rtol 1e-5 at the defaults (eye * 1.0001 chained 64 times: both
  sides sum the same single nonzero term per entry); atol 1e-4 for an
  orthogonal, non-symmetric ``b`` at 64 iterations (f32 sums taken in
  another order; entries of size ~5).
* VPU: rtol 1e-6 (the reference contracts ``acc * 1.000001 + 0.5`` to a
  fused multiply-add, the plain version rounds twice: 1.2e-7 measured).
* SFU: rtol 1e-6 (the chain converges to a fixed point).
* LSU: exact.

The CUDA kernels themselves are held against their plain versions by the
``cuda``-marked tests at the end, which skip without a card and run on one
(with jax installed) with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_microbench.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.kernels import microbench as rm
from repro_torch.kernels import microbench as pm

RTOL = {"MXU": 1e-5, "VPU": 1e-6, "SFU": 1e-6, "LSU": 0.0}
MXU_ORTH_ATOL = 1e-4


def _close(unit, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if RTOL[unit] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[unit], atol=0)


def _ref_square(kernel, a, b, iters):
    """The reference's MXU kernel body on any inputs, as mxu_blocker runs
    it (one block, interpret mode)."""
    t = a.shape[0]
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, iters=iters),
        in_specs=[pl.BlockSpec((t, t), lambda: (0, 0))] * 2,
        out_specs=pl.BlockSpec((t, t), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((t, t), jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)))


def _ref_rows(kernel, x, **kw):
    """The reference's VPU/SFU kernel body on any (rows, 128) input."""
    shape = x.shape
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, **kw),
        in_specs=[pl.BlockSpec(shape, lambda: (0, 0))],
        out_specs=pl.BlockSpec(shape, lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def _ref_lsu(x):
    """The reference's LSU kernel in its own 512-row grid."""
    rows = x.shape[0]
    br = min(512, rows)
    return np.asarray(pl.pallas_call(
        rm._lsu_kernel, grid=(rows // br,),
        in_specs=[pl.BlockSpec((br, rm.TILE), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((br, rm.TILE), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x)))


def _orthogonal(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q.astype(np.float32)


def test_blockers_have_the_reference_keys():
    assert list(pm.BLOCKERS) == list(rm.BLOCKERS)
    assert sorted(pm.launches) == sorted(rm.BLOCKERS)
    assert pm.TILE == rm.TILE


@pytest.mark.parametrize("unit,kw", [
    ("MXU", {}), ("MXU", {"iters": 3, "tile": 16}),
    ("MXU", {"iters": 0, "tile": 32}), ("MXU", {"iters": 5, "tile": 40}),
    ("VPU", {}), ("VPU", {"iters": 7, "rows": 3}),
    ("VPU", {"iters": 1, "rows": 64}),
    ("SFU", {}), ("SFU", {"iters": 3, "rows": 5}),
    ("SFU", {"iters": 300, "rows": 16}),
    ("LSU", {}), ("LSU", {"rows": 8}), ("LSU", {"rows": 512}),
    ("LSU", {"rows": 1536}),
])
def test_public_blocker_matches_reference(unit, kw):
    before = dict(pm.launches)
    got = pm.BLOCKERS[unit](**kw, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(unit, got.numpy(), rm.BLOCKERS[unit](**kw, interpret=True))
    assert pm.launches == before        # the plain version is no launch


@pytest.mark.parametrize("seed", [0, 1])
def test_mxu_inner_kernel_on_an_orthogonal_nonsymmetric_b(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = _orthogonal(rng, 128)
    assert np.abs(b - b.T).max() > 0.1          # not symmetric
    got = pm.mxu_chain(torch.from_numpy(a), torch.from_numpy(b), 64)
    want = _ref_square(rm._mxu_kernel, a, b, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MXU_ORTH_ATOL)
    # a transposed b gives another answer: the check sees the layout
    wrong = pm.mxu_chain(torch.from_numpy(a), torch.from_numpy(b.T.copy()),
                         64)
    assert np.abs(wrong.numpy() - want).max() > 100 * MXU_ORTH_ATOL


@pytest.mark.parametrize("seed,tile,iters", [(2, 16, 9), (3, 48, 4)])
def test_mxu_inner_kernel_on_random_inputs(seed, tile, iters):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (tile, tile)).astype(np.float32)
    b = (rng.uniform(-1, 1, (tile, tile)) / np.sqrt(tile)).astype(np.float32)
    got = pm.mxu_chain(torch.from_numpy(a), torch.from_numpy(b), iters)
    want = _ref_square(rm._mxu_kernel, a, b, iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MXU_ORTH_ATOL)


@pytest.mark.parametrize("unit,seed,rows,iters", [
    ("VPU", 4, 24, 100), ("VPU", 5, 8, 256),
    ("SFU", 6, 24, 50), ("SFU", 7, 8, 128),
])
def test_elementwise_inner_kernels_on_random_inputs(unit, seed, rows, iters):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (rows, 128)).astype(np.float32)
    port = {"VPU": pm.vpu_chain, "SFU": pm.sfu_chain}[unit]
    ref = {"VPU": rm._vpu_kernel, "SFU": rm._sfu_kernel}[unit]
    got = port(torch.from_numpy(x), iters)
    _close(unit, got.numpy(), _ref_rows(ref, x, iters=iters))


@pytest.mark.parametrize("seed,rows", [(8, 512), (9, 1024), (10, 40)])
def test_lsu_inner_kernel_on_random_inputs(seed, rows):
    x = np.random.default_rng(seed).standard_normal((rows, 128)) \
        .astype(np.float32)
    _close("LSU", pm.lsu_stream(torch.from_numpy(x)).numpy(), _ref_lsu(x))


@pytest.mark.parametrize("unit,size", [
    ("MXU", {"iters": 3, "tile": 16}), ("VPU", {"iters": 5, "rows": 3}),
    ("SFU", {"iters": 4, "rows": 2}), ("LSU", {"rows": 8}),
])
def test_blocker_inputs_are_what_the_public_blocker_runs(unit, size):
    assert list(pm.INNER) == list(pm.BLOCKERS)
    args = pm.blocker_inputs(unit, "cpu", **size)
    assert all(a.device.type == "cpu" for a in args
               if isinstance(a, torch.Tensor))
    _, plain = pm.INNER[unit]
    assert torch.equal(pm.BLOCKERS[unit](**size, device="cpu"), plain(*args))


def test_plain_versions_are_what_the_wrappers_run_on_the_cpu():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 2, (4, 128)).astype(np.float32))
    m = torch.from_numpy(rng.uniform(-1, 1, (16, 16)).astype(np.float32))
    assert torch.equal(pm.vpu_chain(x, 9), pm.vpu_chain_ref(x, 9))
    assert torch.equal(pm.sfu_chain(x, 9), pm.sfu_chain_ref(x, 9))
    assert torch.equal(pm.lsu_stream(x), pm.lsu_stream_ref(x))
    assert torch.equal(pm.mxu_chain(m, m, 3), pm.mxu_chain_ref(m, m, 3))
    out = pm.mxu_chain(m, m, 0)
    assert torch.equal(out, m) and out.data_ptr() != m.data_ptr()


def test_wrappers_reject_what_they_do_not_take():
    x = torch.zeros((4, 128))
    with pytest.raises(TypeError, match="float32"):
        pm.vpu_chain(x.double(), 1)
    with pytest.raises(ValueError, match="rows, 128"):
        pm.sfu_chain(torch.zeros((4, 64)), 1)
    with pytest.raises(ValueError, match="square"):
        pm.mxu_chain(torch.zeros((16, 32)), torch.zeros((16, 32)), 1)
    with pytest.raises(ValueError, match="is on"):
        pm.mxu_chain(torch.zeros((16, 16)),
                     torch.zeros((16, 16), device="meta"), 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pm.lsu_stream(x.to("meta"))


# ------------------------------------------------------------- on the card
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
def test_mxu_kernel_rejects_tiles_it_cannot_hold(card):
    for tile in (8, 24, 144):
        a = torch.zeros((tile, tile), device=card)
        with pytest.raises(ValueError, match="multiple of 16"):
            pm.mxu_chain(a, a, 1)
