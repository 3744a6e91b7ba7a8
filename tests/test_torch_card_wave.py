"""The wave-dispatch kernel on the card: equal to its plain version bit for
bit on synthetic waves, and what the kernel does not take raises before any
launch.

Marked ``cuda``: each test skips without a GPU.  The file imports neither
jax nor the reference package, so a GPU host without jax collects and runs
it:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_wave.py

The waves are made with numpy from fixed seeds (:func:`synthetic_wave`) and
reach every path of the kernel: producers in the shared-memory window of
``done`` and beyond it (up to ``S - 1`` rows back), producers at or after
their row (they read 0), every port-width instance on both sides, read
counts of 2 and 4 (unrolled) and others, lanes and rows that fill no block or tile,
invalid rows between valid ones and after the last valid one (where the
kernel ends its walk), blocks with no valid row, sums that wrap past 2**31,
candidate times at the ``INT32_MAX`` sentinel and LUT rows that allow no
port.  Everything is an integer: tolerance 0.  The kernel against the
reference on packed campaign waves stays in ``tests/test_torch_cuda.py``,
which needs jax."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import wave_dispatch as wd

pytestmark = pytest.mark.cuda

INT32_MAX = 2**31 - 1
WINDOW = 128   # rows of `done` the kernel keeps in shared memory


def synthetic_wave(seed, S, E, R, P, M, *, far=0.2, ahead=0.05,
                   invalid=0.2, tail=0.0, dead_from=None, wrap=False,
                   device="cpu"):
    """The kernel's eight inputs for a random wave of ``S`` rows and ``E``
    lanes.  Producer distances: half 1..8, a third 9..32, the rest anywhere
    up to ``j`` (``far`` of them); ``ahead`` of the reads name a row in
    ``j..S-1``; 15% read no producer.  LUT row 0 allows no port.  The last
    ``tail`` of the rows, and every row of the lanes from ``dead_from`` on,
    are invalid (padding).  With ``wrap``, issue times sit just under 2**31
    (some at ``INT32_MAX`` itself) and latencies near 2**30, so sums
    wrap."""
    rng = np.random.default_rng(seed)
    shape = (S, E, R)
    j = np.broadcast_to(np.arange(S)[:, None, None], shape)
    kind = rng.random(shape)
    dist = np.where(kind < 0.5, rng.integers(1, 9, shape),
                    rng.integers(9, 33, shape))
    dist = np.where(kind >= 1.0 - far, rng.integers(1, max(S, 2), shape),
                    dist)
    prod = j - dist
    prod = np.where(rng.random(shape) < ahead, rng.integers(j, S), prod)
    prod = np.where((prod < 0) | (rng.random(shape) < 0.15), -1, prod)
    delta = rng.integers(0, 8, shape)
    if wrap:
        issue = rng.integers(INT32_MAX - 5000, INT32_MAX, (S, E))
        issue[rng.random((S, E)) < 0.1] = INT32_MAX
        lat = rng.integers(2**29, 2**30, (S, E))
    else:
        issue = rng.integers(0, 4 * S, (S, E))
        lat = rng.integers(0, 30, (S, E))
    blk = rng.integers(1, 4, (S, E))
    mask_id = rng.integers(0, M, (S, E))
    valid = rng.random((S, E)) >= invalid
    valid[S - int(tail * S):] = False
    if dead_from is not None:
        valid[:, dead_from:] = False
    lut = rng.random((M, P)) < 0.4
    lut[0] = False
    i32 = [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
           for a in (issue, mask_id, lat, blk)]
    return tuple(t.to(device) for t in (
        *i32, torch.from_numpy(valid),
        torch.from_numpy(prod.astype(np.int32)),
        torch.from_numpy(delta.astype(np.int32)), torch.from_numpy(lut)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _assert_kernel_equals_plain(args):
    before = wd.launches
    done, counts = wd.wave_dispatch(*args)
    torch.cuda.synchronize()
    assert wd.launches == before + 1
    ref_done, ref_counts = wd.wave_dispatch_ref(*args)
    assert torch.equal(done, ref_done), int((done != ref_done).sum())
    assert torch.equal(counts, ref_counts)


# (label, seed, S, E, R, P, M, keywords)
CASES = [
    ("far producers, up to S - 1 rows back", 1, 700, 40, 2, 8, 12,
     {"far": 0.5}),
    ("producers at or after their row", 2, 300, 64, 4, 8, 12,
     {"ahead": 0.3}),
    *[(f"P = {P}", 10 + P, 150, 33, 2, P, 9, {}) for P in
      (1, 7, 8, 9, 16, 17, 32)],
    *[(f"R = {R}, E = {E}", 30 + R, 160, E, R, 8, 11, {}) for R in
      (1, 2, 4, 7) for E in (37, 64)],
    *[(f"S = {S}, E = {E}", 50 + S + E, S, E, 2, 6, 7, {}) for S, E in
      ((1, 1), (33, 3), (257, 45), (97, 100), (131, 256))],
    ("invalid rows between valid ones", 60, 400, 72, 4, 8, 11,
     {"invalid": 0.5}),
    ("padding after the last valid row", 62, 300, 40, 2, 8, 11,
     {"tail": 0.4}),
    ("a block of lanes with no valid row", 63, 200, 70, 4, 8, 11,
     {"dead_from": 32}),
    ("sums past 2**31 and the INT32_MAX sentinel", 61, 300, 48, 4, 11, 9,
     {"wrap": True}),
]


@pytest.mark.parametrize("label,seed,S,E,R,P,M,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_equals_plain_version_on_synthetic_waves(card, label, seed, S,
                                                        E, R, P, M, kw):
    args = synthetic_wave(seed, S, E, R, P, M, device=card, **kw)
    issue, prod, valid = args[0], args[5], args[4]
    j = torch.arange(S, device=card)[:, None, None]
    read = (prod >= 0) & valid[..., None]
    if "far" in kw:
        assert int(((j - prod) * read).max()) >= WINDOW
    if "ahead" in kw:
        assert bool((read & (prod >= j)).any())
    if kw.get("wrap"):
        assert bool((issue == INT32_MAX).any())
    _assert_kernel_equals_plain(args)


def test_kernel_on_planes_off_16_byte_alignment(card):
    """Contiguous inputs that start 4 bytes past an aligned address (E a
    multiple of 4): the kernel takes its 4-byte copies."""
    args = synthetic_wave(70, 200, 64, 4, 8, 10, device=card)

    def shifted(t):
        flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=card)
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view
    moved = tuple(shifted(t) for t in args[:7]) + (args[7],)
    assert all(t.is_contiguous() for t in moved)
    assert moved[0].data_ptr() % 16 != 0
    _assert_kernel_equals_plain(moved)


def test_kernel_at_many_masks_and_reads(card):
    """12,288 port masks (48 KB of them in shared memory) and 32 reads a
    row: the tile shrinks to fit shared memory, and S is not a multiple of
    it."""
    M, R, S = 12 * 1024, 32, 45
    T = wd.rows_per_tile(R, M)
    assert 1 <= T < wd.rows_per_tile(4, 16) and S % T
    _assert_kernel_equals_plain(synthetic_wave(71, S, 35, R, 8, M,
                                               device=card))


def test_out_of_range_mask_ids_allow_no_port(card):
    """Mask ids outside 0..M-1 (the plain version raises on them) allow no
    port in the kernel: the result equals the plain version's with those
    ids pointing at an appended LUT row of no port."""
    args = list(synthetic_wave(72, 200, 40, 2, 8, 6, device=card))
    M = args[7].shape[0]
    rng = np.random.default_rng(72)
    out = torch.from_numpy(rng.random((200, 40)) < 0.2).to(card)
    bad = torch.from_numpy(rng.choice([M, M + 5, 10**6, -1, -7],
                                      (200, 40)).astype(np.int32)).to(card)
    args[1] = torch.where(out, bad, args[1])
    done, counts = wd.wave_dispatch(*args)
    torch.cuda.synchronize()
    lut = torch.cat([args[7], torch.zeros((1, 8), dtype=torch.bool,
                                          device=card)])
    mask = torch.where(out, torch.full_like(args[1], M), args[1])
    want = wd.wave_dispatch_ref(*args[:1], mask, *args[2:7], lut)
    assert torch.equal(done, want[0]) and torch.equal(counts, want[1])


def test_launch_picks_the_smallest_port_width(card):
    widths = {P: wd.port_width(P) for P in (0, 1, 7, 8, 9, 16, 17, 32, 33)}
    assert widths == {0: 0, 1: 8, 7: 8, 8: 8, 9: 32, 16: 32, 17: 32, 32: 32,
                      33: 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    S, E = 4, 3
    z = torch.zeros((S, E), dtype=torch.int32, device=card)
    args = [z, z, z, z, torch.ones((S, E), dtype=torch.bool, device=card),
            torch.full((S, E, 1), -1, dtype=torch.int32, device=card),
            torch.zeros((S, E, 1), dtype=torch.int32, device=card),
            torch.ones((2, 33), dtype=torch.bool, device=card)]
    with pytest.raises(ValueError, match="ports"):
        wd.wave_dispatch(*args)
    args[7] = torch.ones((2, 8), dtype=torch.bool, device=card)
    args[0] = torch.zeros((E, S), dtype=torch.int32, device=card).t()
    with pytest.raises(ValueError, match="contiguous"):
        wd.wave_dispatch(*args)
    args[0] = z.cpu()
    with pytest.raises(ValueError, match="is on"):
        wd.wave_dispatch(*args)
    args[0] = z
    args[5] = torch.full((S, E, 2000), -1, dtype=torch.int32, device=card)
    args[6] = torch.zeros((S, E, 2000), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        wd.wave_dispatch(*args)
    args[5] = torch.full((S, E, 1), -1, dtype=torch.int32, device=card)
    args[6] = torch.zeros((S, E, 1), dtype=torch.int32, device=card)
    args[7] = torch.ones((60_000, 8), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        wd.wave_dispatch(*args)


def test_traced_waves_record_the_kernel_interval_on_the_device_track(card):
    """A traced wave's device-track ``wave.kernel`` span is the kernel's
    CUDA-event interval, recorded when the outputs reach the host, not the
    launch's host interval: on every traced wave the spans sum to the
    executor's ``kernel_ns``, one span a launch."""
    from repro_torch.core.batch_sim import BatchSimMachine
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.machine import RegPool, independent_seq
    from repro_torch.core.uarch import SIM_SKL
    from repro_torch.obs import tracer as obs

    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", device=card,
                        min_lanes=1)
    codes = [independent_seq(TEST_ISA[s], RegPool(), 3) * n
             for s in ("ADD_R64_R64", "IMUL_R64_R64", "DIV_R64", "CMC")
             for n in (10, 110)]
    tr = obs.Tracer(enabled=True)
    old = obs.set_tracer(tr)
    try:
        calls = 0
        for n in (len(codes), 3, len(codes)):
            m.run_batch(codes[:n])
            st = m.device_stats()
            spans = [e for e in tr.events() if e["name"] == "wave.kernel"]
            assert {e["tid"] for e in spans} == {"device:cuda:0"}
            assert len(spans) == st["kernel_calls"] > calls
            assert sum(e["dur"] for e in spans) == \
                st["kernel_ns"]["device:cuda:0"]
            calls = st["kernel_calls"]
    finally:
        obs.set_tracer(old)


@pytest.mark.parametrize("placement", [("cuda:0", "cuda:0"),
                                       ("cuda:0", "cuda:1")],
                         ids=["one card twice", "two cards"])
def test_lane_blocks_equal_the_one_device_launch(card, placement):
    """A wide chunk (one chunk of 200 lanes, a few hundred rows each) on two
    logical devices runs as two lane blocks: each block's kernel equals
    its plain version, the blocks joined along the lanes equal the
    one-device launch of the whole chunk on its real lanes, and the
    Counters are equal."""
    from repro_torch.core.batch_sim import BatchSimMachine
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.machine import RegPool, independent_seq
    from repro_torch.core.uarch import SIM_SKL

    if torch.cuda.device_count() < len(set(placement)):
        pytest.skip(f"needs {len(set(placement))} cards, the host has "
                    f"{torch.cuda.device_count()}")
    specs = ("ADD_R64_R64", "IMUL_R64_R64", "DIV_R64", "MULPS_X_X",
             "ADC_R64_R64", "MOV_M64_R64", "SHLD_R64_R64_I8", "PADDD_X_X")
    codes = [independent_seq(TEST_ISA[specs[i % len(specs)]], RegPool(), 3)
             * (40 + i % 50) for i in range(200)]
    one = BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", device=card)
    two = BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda",
                          devices=placement)
    one.launched_args, two.launched_args = [], []
    before = wd.launches
    got_one, got_two = one.run_batch(codes), two.run_batch(codes)
    assert wd.launches == before + 3             # one chunk, then 2 blocks
    assert [(c.cycles, c.port_uops) for c in got_one] == \
        [(c.cycles, c.port_uops) for c in got_two]
    (whole,), blocks = one.launched_args, two.launched_args
    assert [b[0].device for b in blocks] == [torch.device(d)
                                             for d in placement]
    outs = []
    for args in blocks:
        _assert_kernel_equals_plain(args)
        outs.append(tuple(t.cpu() for t in wd.wave_dispatch(*args)))
    done, counts = (t.cpu() for t in wd.wave_dispatch(*whole))
    torch.cuda.synchronize()
    lanes = len(codes)
    assert torch.equal(torch.cat([o[0] for o in outs], 1)[:, :lanes],
                       done[:, :lanes])
    assert torch.equal(torch.cat([o[1] for o in outs], 0)[:lanes],
                       counts[:lanes])
    st = two.device_stats()
    assert st["mesh"] is True and st["devices"] == list(placement)
    assert st["kernel_calls"] == 1
    assert sum(c["lanes"] for c in st["per_device"].values()) == lanes
    assert sum(c["kernel_calls"] for c in st["per_device"].values()) == 2
