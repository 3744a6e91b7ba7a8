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
    """(C*S + S) * 4 bytes above the 48 KB a block takes without opting in.
    (11, 1100) and (1, 12,300) opt in to dynamic shared memory as padded
    int tables; (32, 4096), 528 KB, is above the 227 KB opt-in and is read
    through L1/L2."""
    assert (C * S + S) * 4 > 48 * 1024
    assert_kernel_equals_plain(*random_case(S, 700, C, S), card)


# the persistent design: a CTA takes ceil(B / CTAs) rows, up to what a
# 16 KB buffer holds (at least a pass of at most 1024 rows), and at most
# two CTAs run a streaming multiprocessor
MAX_TILE_ROWS = 1024
SMEM_OPTIN = 227 * 1024


@pytest.mark.parametrize("B", [2, 3, 5, 7, 9, 17, 33, 63, 65, 255, 257,
                               1023, 4099, 9937])
def test_rows_off_the_tile_and_the_lane_group(card, B):
    """Row counts that are multiples of neither a row tile nor a lane
    group: the last tile is ragged and its idle groups still take part in
    the warp's ballots and shuffles."""
    assert_kernel_equals_plain(*random_case(B, B, 11, 71, zero_rows=0.1),
                               card)


@pytest.mark.parametrize("C,S", [(9, 31), (11, 71)])
def test_more_row_tiles_than_persistent_ctas(card, C, S):
    """Every CTA walks at least three row tiles: double buffering wraps."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    B = 3 * 2 * sms * MAX_TILE_ROWS + 13
    assert_kernel_equals_plain(*random_case(B + C, B, C, S, zero_rows=0.2),
                               card)


@pytest.mark.parametrize("C", [31, 32, 33])
@pytest.mark.parametrize("S", [1, 71, 300])
def test_combinations_around_the_bit_set(card, C, S):
    """C = 32 is the last count whose row's nonzero combinations fit one
    32-bit ballot set, summed over a padded table; C = 33 takes the plain
    loop over every combination.  Dense rows and sparse ones."""
    for seed, zero in ((C * S, 0.0), (C * S + 1, 0.5)):
        u, mask, size = random_case(seed, 3000, C, S, zero_rows=zero)
        u[u % 3 == 0] = 0                   # scattered zero counts
        assert_kernel_equals_plain(u, mask, size, card)


@pytest.mark.parametrize("C,S,B", [(33, 400, 900), (11, 4000, 900),
                                   (32, 1000, 900), (11, 8000, 900),
                                   (33, 2000, 900), (11, 30_000, 900),
                                   (1000, 40, 20_000), (1000, 100, 20_000)])
def test_tables_above_48_kb_and_above_the_opt_in(card, C, S, B):
    """Above 48 KB the table opts in to dynamic shared memory, up to the
    227 KB opt-in: the int table at (33, 400); at C <= 32 the padded int
    table (each mask row a multiple of a pass of candidates, at most 127
    columns longer) at (11, 4000) and (32, 1000).  Above the opt-in it is
    read through L1/L2: (33, 2000), and at C <= 32 (11, 8000) and
    (11, 30,000).  At C = 1000 and 20,000 rows two u tiles of 64 rows do
    not fit: u is read in place, with the int table in shared memory
    (S = 40) or not (S = 100)."""
    ints = (C * S + S) * 4
    assert ints > 48 * 1024
    if C <= 32:         # padded, with two small u buffers, or not at all
        in_smem = (C + 1) * (S + 127) * 4 < SMEM_OPTIN - 4096
        assert in_smem == ((C, S) in {(11, 4000), (32, 1000)})
        assert in_smem or ints > SMEM_OPTIN
    if C == 1000:
        assert 2 * 64 * C * 4 > SMEM_OPTIN
        assert (ints <= SMEM_OPTIN) == (S == 40)
    assert_kernel_equals_plain(*random_case(C + S, B, C, S,
                                            zero_rows=0.1), card)


def _raw_launch(u, mask, size):
    """The C entry point on ``u`` as it is: no copy, even off 16 bytes."""
    B, C = u.shape
    out = torch.empty((2, B), dtype=torch.int32, device=u.device)
    pb.LIBRARY.launch("port_bound_launch", u.device, u.data_ptr(),
                      mask.data_ptr(), size.data_ptr(), out.data_ptr(), B, C,
                      mask.shape[1])
    return out


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("B,C", [(1, 1), (2, 1), (5, 3), (77, 5), (300, 11),
                                 (4099, 11), (600, 33)])
def test_u_off_16_byte_alignment(card, offset, B, C):
    """u starting 4, 8 or 12 bytes past a 16-byte boundary, rows of C * 4
    bytes: the kernel copies the unaligned head and tail of every tile 4
    bytes at a time.  Straight through the C entry point, and through the
    wrapper, which copies such a view first."""
    u, mask, size = random_case(B * C + offset, B, C, 71, zero_rows=0.1)
    flat = torch.zeros(B * C + 8, dtype=torch.int32, device=card)
    flat[offset:offset + B * C] = torch.from_numpy(u.reshape(-1)).to(card)
    view = flat[offset:offset + B * C].view(B, C)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    mask_d, size_d = (torch.from_numpy(a).to(card) for a in (mask, size))
    want = quotients(*pb.port_bound_ref(view, mask_d, size_d))
    got = _raw_launch(view, mask_d, size_d)
    torch.cuda.synchronize()
    assert np.array_equal(quotients(*got), want)
    assert np.array_equal(quotients(*pb.port_bound(view, mask_d, size_d)),
                          want)
    assert np.array_equal(flat[:offset].cpu().numpy(),
                          np.zeros(offset, np.int32))


def test_one_2_by_B_output(card):
    """One int32 (2, B) tensor on the card, num in row 0 and den in row
    1; unpacking gives the rows as views; one launch a call."""
    args = [torch.from_numpy(a).to(card)
            for a in random_case(4, 1000, 11, 71)]
    before = pb.launches
    out = pb.port_bound(*args)
    assert pb.launches == before + 1
    assert out.shape == (2, 1000) and out.dtype == torch.int32
    assert out.is_contiguous() and out.device == args[0].device
    num, den = out
    assert num._base is out and den._base is out
    assert den.data_ptr() == out.data_ptr() + 4 * 1000
    assert np.array_equal(quotients(num, den),
                          quotients(*pb.port_bound_ref(*args)))


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
