"""The port-bound kernel (``csrc/port_bound.cu``) against its plain
PyTorch version on the card, and the ``cuda`` predict backend against the
``numpy`` one.

Marked ``cuda``: each test skips without a GPU.  The file imports neither
jax nor the reference package, so a GPU host without jax runs it
(``chip_smoke.py``'s ``[card-tests]`` phase).  Results are compared as
float64 quotients ``num / den``, bit for bit: two candidates of equal
ratio may come back as different pairs, whose quotients are the same
double."""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import Campaign
from repro_torch.core.isa import TEST_ISA
from repro_torch.core.simulator import Instr, SimMachine
from repro_torch.core.uarch import SIM_UARCHES
from repro_torch.kernels import port_bound as pb
from repro_torch.service.batch_predictor import BatchPredictor
from repro_torch.service.workload import random_blocks

pytestmark = pytest.mark.cuda

GUARD = 2 ** 31
NAMES = ["ADD_R64_R64", "IMUL_R64_R64", "MUL_R64", "ADC_R64_R64", "CMC",
         "TEST_R64_R64", "SHLD_R64_R64_I8", "MOVQ2DQ_X_X", "AESDEC_X_X",
         "PSHUFD_X_X", "PADDD_X_X", "MOV_R64_M64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def random_case(seed, B, C, S, *, density=0.4, zero_rows=0.0):
    """``(u, mask, size)`` as numpy int32, inside the reference's guard
    (row total * max size < 2**31)."""
    rng = np.random.default_rng(seed)
    size = rng.integers(1, 9, S).astype(np.int32)
    hi = max(1, min(1000, (GUARD - 1) // (max(C, 1) * int(size.max()))))
    u = rng.integers(0, hi, (B, C)).astype(np.int32)
    u[rng.random(B) < zero_rows] = 0
    mask = (rng.random((C, S)) < density).astype(np.int32)
    return u, mask, size


def quotients(num, den):
    return (num.cpu().numpy().astype(np.float64)
            / den.cpu().numpy().astype(np.float64)).view(np.int64)


def assert_kernel_equals_plain(u, mask, size, device):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (u, mask, size)]
    before = pb.launches
    num, den = pb.port_bound(*args)
    torch.cuda.synchronize()
    assert pb.launches == before + (1 if len(u) else 0)
    rnum, rden = pb.port_bound_ref(*args)
    assert np.array_equal(quotients(num, den), quotients(rnum, rden))
    assert bool((den > 0).all())
    return num, den


SHAPES = [(B, C, S) for B in (1, 31, 32, 4096, 10_000)
          for C in (1, 11, 32) for S in (1, 71, 300)]


@pytest.mark.parametrize("B,C,S", SHAPES)
def test_random_inputs(card, B, C, S):
    assert_kernel_equals_plain(*random_case(B * 7 + C * 3 + S, B, C, S,
                                            zero_rows=0.1), card)


@pytest.mark.parametrize("C,S", [(11, 1100), (32, 4096), (1, 12_300)])
def test_tables_too_large_for_shared_memory(card, C, S):
    """(C*S + S) * 4 bytes above 48 KB: mask and size are read through
    L1/L2."""
    assert (C * S + S) * 4 > 48 * 1024
    assert_kernel_equals_plain(*random_case(S, 700, C, S), card)


def test_ties_zero_rows_and_the_guard(card):
    rng = np.random.default_rng(5)
    # every candidate the same ratio
    assert_kernel_equals_plain(np.full((64, 4), 3, np.int32),
                               np.eye(4, dtype=np.int32),
                               np.ones(4, np.int32), card)
    # equal rationals of different terms: u0 / 1 == 2 u0 / 2
    u = rng.integers(0, 10, (300, 6)).astype(np.int32)
    u[:, 0] = u[:, 1] = rng.integers(50, 99, 300)
    mask = (rng.random((6, 40)) < 0.4).astype(np.int32)
    size = np.full(40, 8, np.int32)
    mask[:, 3], size[3] = [1, 0, 0, 0, 0, 0], 1
    mask[:, 33], size[33] = [1, 1, 0, 0, 0, 0], 2
    num, den = assert_kernel_equals_plain(u, mask, size, card)
    assert np.array_equal(quotients(num, den),
                          u[:, 0].astype(np.float64).view(np.int64))
    # all-zero rows give 0.0
    u, mask, size = random_case(9, 500, 11, 71)
    u[::2] = 0
    num, den = assert_kernel_equals_plain(u, mask, size, card)
    assert not num[::2].any()
    # row totals just below the guard
    u, mask, size = random_case(10, 256, 11, 71)
    cap = (GUARD - 1) // int(size.max())
    u[:] = 0
    u[:, 0] = cap - np.arange(256)
    u[::2, :3] = cap // 3
    assert int(u.sum(1).max()) * int(size.max()) < GUARD
    assert_kernel_equals_plain(u, mask, size, card)


def test_empty_and_degenerate_shapes(card):
    assert_kernel_equals_plain(np.zeros((0, 11), np.int32),
                               np.ones((11, 71), np.int32),
                               np.ones(71, np.int32), card)
    assert_kernel_equals_plain(np.zeros((9, 0), np.int32),
                               np.zeros((0, 5), np.int32),
                               np.ones(5, np.int32), card)
    num, den = assert_kernel_equals_plain(np.ones((9, 3), np.int32),
                                          np.ones((3, 0), np.int32),
                                          np.ones(0, np.int32), card)
    assert not num.any() and bool((den == 1).all())


def test_views_are_copied(card):
    u, mask, size = (torch.from_numpy(a).to(card)
                     for a in random_case(3, 77, 11, 71))
    ut = u.t().contiguous().t()                      # transposed storage
    assert not ut.is_contiguous()
    num, den = pb.port_bound(ut, mask, size)
    rnum, rden = pb.port_bound_ref(u, mask, size)
    assert np.array_equal(quotients(num, den), quotients(rnum, rden))


@pytest.fixture(scope="module")
def card_models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return Campaign(instr_names=NAMES).run(
        [SimMachine(ua, TEST_ISA, backend="cuda")
         for ua in SIM_UARCHES.values()], TEST_ISA).models


@pytest.mark.parametrize("uarch", sorted(SIM_UARCHES))
def test_cuda_backend_equals_numpy(card_models, uarch):
    model = card_models[uarch]
    bp = BatchPredictor(model, TEST_ISA, backend="cuda")
    host = BatchPredictor(model, TEST_ISA, backend="numpy")
    for seed, n in ((7, 64), (8, 5), (9, 3000)):
        blocks = random_blocks(model, TEST_ISA, n, seed=seed, max_len=8)
        blocks.append([Instr("DIVPS_X_X", {"op1": "X0", "op2": "X1"})])
        before = pb.launches
        got = bp.predict_batch(blocks, on_error="return")
        want = host.predict_batch(blocks, on_error="return")
        assert [repr(g) for g in got] == [repr(w) for w in want]
        assert pb.launches == before + (n >= bp.min_device_blocks)
    st = bp.backend_stats()
    assert st["backend"] == "cuda" and st["device_compiles"] == 1
    assert st["device_waves"] == 2 and st["device_fallbacks"] == 0


def test_torch_backend_on_the_card_launches_the_kernel(card_models):
    model = card_models["sim_skl"]
    bp = BatchPredictor(model, TEST_ISA, backend="torch", device="cuda")
    host = BatchPredictor(model, TEST_ISA, backend="numpy")
    blocks = random_blocks(model, TEST_ISA, 64, seed=12, max_len=8)
    before = pb.launches
    got = bp.predict_batch(blocks)
    assert [repr(g) for g in got] == \
        [repr(w) for w in host.predict_batch(blocks)]
    assert pb.launches == before + 1
