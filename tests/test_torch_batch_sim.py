"""The port's wave execution against the reference package: the port's
``torch`` backend (the CUDA kernel's plain version, on the CPU) gives
Counters equal to the reference's ``pallas`` backend (the TPU kernel in
interpret mode), its ``numpy`` backend and its scalar oracle, on the same
waves — and ``wave_dispatch_ref`` equals the reference's
``_kernel_numpy`` row for row.  Everything is an integer: tolerance 0."""
import random

import numpy as np
import pytest
import torch

from repro.core import batch_sim as r_bs
from repro.core import isa as r_isa
from repro.core import uarch as r_uarch
from repro.core.machine import RegPool, independent_seq
from repro.core.simulator import Instr as RInstr
from repro.core.simulator import SimMachine as RSim
from repro_torch.core import batch_sim as p_bs
from repro_torch.core import isa as p_isa
from repro_torch.core import uarch as p_uarch
from repro_torch.core.simulator import Instr as PInstr
from repro_torch.core.simulator import SimMachine as PSim
from repro_torch.kernels import wave_dispatch as wd

import test_torch_card_wave as card_wave


def _port_codes(codes):
    """The same wave as the port's instruction objects (repeated bodies
    keep sharing objects, as the engine's unrollings do)."""
    memo = {}

    def conv(ins):
        got = memo.get(id(ins))
        if got is None:
            got = memo[id(ins)] = PInstr(ins.spec, dict(ins.regs),
                                         ins.value_hint)
        return got
    return [[conv(i) for i in c] for c in codes]


def _port_machine(ua, isa, **kw):
    return p_bs.BatchSimMachine(ua, isa, backend="torch", device="cpu",
                                min_lanes=kw.pop("min_lanes", 1), **kw)


def _counters(res):
    return [(c.cycles, dict(c.port_uops)) for c in res]


def assert_port_matches_reference(pair, codes, ref_backends=("numpy",)):
    """Port ``torch`` backend == reference scalar oracle == each named
    reference backend, lane for lane."""
    ra, ri, pa, pi = pair
    got = _counters(_port_machine(pa, pi).run_batch(_port_codes(codes)))
    assert len(got) == len(codes)
    scalar = RSim(ra, ri)
    oracle = [(c.cycles, dict(c.port_uops))
              for c in (scalar.run(list(code)) for code in codes)]
    assert got == oracle
    for backend in ref_backends:
        if backend != "numpy":
            pytest.importorskip("jax")
        ref = r_bs.BatchSimMachine(ra, ri, backend=backend, min_lanes=1)
        assert got == _counters(ref.run_batch(codes)), backend


def _sim(name):
    return (r_uarch.SIM_UARCHES[name], r_isa.TEST_ISA,
            p_uarch.SIM_UARCHES[name], p_isa.TEST_ISA)


def _interesting_wave(isa):
    """Zero idioms (both kinds), move elimination, same-register variants,
    dividers (both value classes), loads/stores + forwarding,
    partial-register stalls, flags chains, NOP-likes — unrolled the way
    Algorithm 2 unrolls them (the reference batch tests' wave)."""
    codes = []
    for spec in ("ADD_R64_R64", "MOV_R64_R64", "XOR_R64_R64", "DIV_R64",
                 "SHLD_R64_R64_I8", "MOV_M64_R64", "AESDEC_X_X",
                 "MOVQ2DQ_X_X", "ADC_R64_R64", "MUL_R64", "PCMPGTQ_X_X",
                 "PAUSE", "ADD_R64_M64"):
        body = independent_seq(isa[spec], RegPool(), 3)
        codes.append(body * 10)
        codes.append(body * 110)
    codes += [
        [RInstr("SHLD_R64_R64_I8", {"op1": "R0", "op2": "R0"})] * 30,
        [RInstr("DIV_R64", {"op1": "R0", "op2": "R1"}, "high")] * 15,
        [RInstr("XOR_R64_R64", {"op1": "R3", "op2": "R3"}),
         RInstr("IMUL_R64_R64", {"op1": "R3", "op2": "R4"})] * 40,
        [RInstr("MOV_R64_R64", {"op1": f"R{(i + 1) % 8}",
                                "op2": f"R{i % 8}"}) for i in range(8)] * 9,
        [RInstr("SETC_R8", {"op1": "R1"}),
         RInstr("ADD_R64_R64", {"op1": "R2", "op2": "R1"}),
         RInstr("TEST_R64_R64", {"op1": "R2", "op2": "R2"})] * 35,
        [RInstr("MOV_M64_R64", {"mem": "RB0", "op1": "R1"}),
         RInstr("MOV_R64_M64", {"op1": "R1", "mem": "RB0"})] * 20,
    ]
    return codes


@pytest.mark.parametrize("uarch", sorted(r_uarch.SIM_UARCHES))
def test_interesting_wave_equals_reference(uarch):
    assert_port_matches_reference(_sim(uarch),
                                  _interesting_wave(r_isa.TEST_ISA))


def test_interesting_wave_equals_pallas_interpret():
    assert_port_matches_reference(_sim("sim_skl"),
                                  _interesting_wave(r_isa.TEST_ISA),
                                  ref_backends=("pallas",))


def test_ragged_and_empty_waves():
    pair = _sim("sim_skl")
    body = independent_seq(r_isa.TEST_ISA["IMUL_R64_R64"], RegPool(), 4)
    ragged = [body * 1, body * 37, [], body * 110,
              [RInstr("ADD_R64_R64", {"op1": "R0", "op2": "R1"})], body * 10]
    assert_port_matches_reference(pair, ragged, ("numpy", "pallas"))
    edge = [[], [RInstr("ADD_R64_R64", {"op1": "R0", "op2": "R1"})],
            [RInstr("NOP", {})] * 50]
    assert_port_matches_reference(pair, edge, ("numpy",))
    assert _port_machine(pair[2], pair[3]).run_batch([]) == []


def _tie_pair(ports):
    """Waves where several ports repeatedly tie on both dispatch time and
    cumulative μop count (the reference batch tests' tie wave), built in
    both packages."""
    out = []
    for isa_mod, uarch_mod in ((r_isa, r_uarch), (p_isa, p_uarch)):
        wide_mask = frozenset(ports)
        narrow_mask = frozenset(sorted(ports)[:2])
        b = {"TIEW": uarch_mod.beh(uarch_mod.uop(wide_mask, ("op2",),
                                                 ("op1",))),
             "TIEN": uarch_mod.beh(uarch_mod.uop(narrow_mask, ("op2",),
                                                 ("op1",)))}
        ua = uarch_mod.UArch("sim_tie", tuple(ports), 8, b,
                             overhead_cycles=0)
        ops = (isa_mod.op("op1", isa_mod.GPR, "w"),
               isa_mod.op("op2", isa_mod.GPR, "r"))
        isa = isa_mod.ISA([isa_mod.InstrSpec("TIEW", "TIEW", ops),
                           isa_mod.InstrSpec("TIEN", "TIEN", ops)])
        out += [ua, isa]
    codes = []
    for reps in (1, 3, 11):
        codes.append([RInstr("TIEW", {"op1": f"R{i}", "op2": f"R{i + 32}"})
                      for i in range(3 * len(ports))] * reps)
        codes.append([RInstr(("TIEW", "TIEN")[i % 2],
                             {"op1": f"R{i}", "op2": f"R{i + 40}"})
                      for i in range(2 * len(ports))] * reps)
    return tuple(out), codes


@pytest.mark.parametrize("n_ports", [2, 8, 16, 17, 18, 32])
def test_tie_breaks_at_port_count_boundaries(n_ports):
    if n_ports == 8:
        widest = max(r_uarch.SIM_UARCHES.values(), key=lambda u: len(u.ports))
        ports = sorted(widest.ports)
    else:
        ports = [f"p{i:02d}" for i in range(n_ports)]
    pair, codes = _tie_pair(ports)
    backends = ("numpy", "pallas") if n_ports in (8, 18) else ("numpy",)
    assert_port_matches_reference(pair, codes, backends)


def test_wide_port_machine_counts_exact():
    ports = tuple(f"p{i:02d}" for i in range(18))
    pair = []
    for isa_mod, uarch_mod in ((r_isa, r_uarch), (p_isa, p_uarch)):
        b = {"WADD": uarch_mod.beh(uarch_mod.uop(frozenset(ports), ("op2",),
                                                 ("op1",)))}
        pair += [uarch_mod.UArch("sim_wide", ports, 8, b, overhead_cycles=0),
                 isa_mod.ISA([isa_mod.InstrSpec(
                     "WADD", "WADD", (isa_mod.op("op1", isa_mod.GPR, "w"),
                                      isa_mod.op("op2", isa_mod.GPR, "r")))])]
    codes = [[RInstr("WADD", {"op1": f"R{i}", "op2": f"R{i + 20}"})
              for i in range(20)] * reps for reps in (1, 5, 11)]
    assert_port_matches_reference(tuple(pair), codes, ("numpy", "pallas"))


def _random_wave(ua_seed, wave_seed, n_codes=8):
    ra, ri, truth = r_uarch.random_uarch_and_isa(ua_seed)
    pa, pi, _ = p_uarch.random_uarch_and_isa(ua_seed)
    rng = random.Random(wave_seed)
    names = list(truth)
    codes = []
    for _ in range(n_codes):
        body = [RInstr(rng.choice(names),
                       {"op1": f"R{rng.randint(0, 5)}",
                        "op2": f"R{rng.randint(0, 5)}"})
                for _ in range(rng.randint(1, 5))]
        codes.append(body * rng.choice([1, 3, 10, 37, 110]))
    return (ra, ri, pa, pi), codes


@pytest.mark.parametrize("seed", range(6))
def test_random_ground_truths(seed):
    pair, codes = _random_wave(seed, seed + 100)
    assert_port_matches_reference(pair, codes,
                                  ("numpy", "pallas") if seed < 2
                                  else ("numpy",))


def test_tpu_unit_model():
    ra, ri, truth = r_uarch.make_tpu_sim()
    pa, pi, _ = p_uarch.make_tpu_sim()
    names = list(truth)
    codes = [[RInstr(names[(i + j) % len(names)],
                     {"op1": f"R{j % 4}", "op2": f"R{(j + 1) % 4}"})
              for j in range(4)] * reps for i, reps in
             enumerate((1, 10, 30, 110))]
    assert_port_matches_reference((ra, ri, pa, pi), codes)


# ---------------------------------------------------------------------------
# the plain version against the reference's numpy kernel, row for row
# ---------------------------------------------------------------------------


def _reference_pack(pair, codes):
    """Reference-packed chunks of ``codes``: the row-major ``(S, E)``
    numpy-kernel layout with zeroed padding."""
    ra, ri = pair[0], pair[1]
    m = r_bs.BatchSimMachine(ra, ri, backend="numpy", min_lanes=1)
    idx = list(range(len(codes)))
    progs = m._lower_wave(codes, [idx])
    return m, m._pack_chunk(idx, progs)


def _as_torch(pk, comp):
    return (torch.from_numpy(pk.issue), torch.from_numpy(pk.mask),
            torch.from_numpy(pk.lat), torch.from_numpy(pk.blk),
            torch.from_numpy(pk.valid), torch.from_numpy(pk.prod),
            torch.from_numpy(pk.delta),
            torch.from_numpy(np.ascontiguousarray(comp.mask_table)))


@pytest.mark.parametrize("case", ["sim_skl", "sim_hsw", "sim_snb", "tie18",
                                  "random:3"])
def test_plain_version_equals_reference_numpy_kernel(case):
    if case.startswith("sim_"):
        pair, codes = _sim(case), _interesting_wave(r_isa.TEST_ISA)
    elif case == "tie18":
        pair, codes = _tie_pair([f"p{i:02d}" for i in range(18)])
    else:
        pair, codes = _random_wave(3, 77)
    m, pk = _reference_pack(pair, codes)
    ref_done, ref_counts = m._kernel_numpy(pk)
    args = _as_torch(pk, m._comp)
    done, counts = wd.wave_dispatch_ref(*args)
    valid = pk.valid
    np.testing.assert_array_equal(done.numpy()[valid], ref_done[valid])
    assert not done.numpy()[~valid].any()   # invalid rows are gated to 0
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = wd.launches
    done2, counts2 = wd.wave_dispatch(*args)
    assert wd.launches == before
    assert torch.equal(done2, done) and torch.equal(counts2, counts)


def test_plain_version_gates_stale_rows_on_valid():
    """Rows that are not valid hold stale garbage in reused buffers: they
    must produce 0 and leave port state alone (the TPU kernel's gating,
    which the reference numpy kernel does not need)."""
    pair, codes = _random_wave(5, 9)
    m, pk = _reference_pack(pair, codes)
    ref_done, ref_counts = m._kernel_numpy(pk)
    rng = np.random.default_rng(5)
    S, E = pk.issue.shape
    stale = ~pk.valid
    issue, mask, lat, blk = (a.copy() for a in (pk.issue, pk.mask, pk.lat,
                                                pk.blk))
    prod, delta = pk.prod.copy(), pk.delta.copy()
    issue[stale] = rng.integers(0, 10**6, stale.sum())
    mask[stale] = rng.integers(0, m._comp.mask_table.shape[0], stale.sum())
    lat[stale] = rng.integers(0, 99, stale.sum())
    blk[stale] = rng.integers(0, 99, stale.sum())
    prod[stale] = rng.integers(-1, S, (stale.sum(), prod.shape[2]))
    delta[stale] = rng.integers(0, 9, (stale.sum(), prod.shape[2]))
    lut = torch.from_numpy(np.ascontiguousarray(m._comp.mask_table))
    done, counts = wd.wave_dispatch_ref(
        *(torch.from_numpy(a) for a in (issue, mask, lat, blk, pk.valid,
                                        prod, delta)), lut)
    np.testing.assert_array_equal(done.numpy()[pk.valid],
                                  ref_done[pk.valid])
    assert not done.numpy()[stale].any()
    np.testing.assert_array_equal(counts.numpy(), ref_counts)


def _far_codes():
    """Loops whose body reads a register written 131..200 μop rows back:
    every body's last ADD reads the IMUL result at the body's start."""
    def code(gap, reps):
        body = [RInstr("IMUL_R64_R64", {"op1": "R0", "op2": "R1"})]
        body += [RInstr("ADD_R64_R64", {"op1": f"R{2 + i % 12}",
                                        "op2": f"R{2 + (i + 5) % 12}"})
                 for i in range(gap)]
        body.append(RInstr("ADD_R64_R64", {"op1": "R1", "op2": "R0"}))
        return body * reps
    return [code(150, 3), code(200, 2), code(131, 5), code(40, 7)]


@pytest.mark.parametrize("uarch", ["sim_skl", "sim_hsw", "sim_snb"])
def test_plain_version_on_producers_beyond_the_kernels_window(uarch):
    """Producers more than 128 rows back (past the kernel's shared-memory
    window of ``done``, which then reads them from global memory): the plain
    version equals the reference's numpy kernel on a reference-packed
    chunk."""
    m, pk = _reference_pack(_sim(uarch), _far_codes())
    S = pk.issue.shape[0]
    j = np.arange(S)[:, None, None]
    far = (pk.prod >= 0) & pk.valid[..., None] & (j - pk.prod > 128)
    assert far.sum() >= 4
    ref_done, ref_counts = m._kernel_numpy(pk)
    done, counts = wd.wave_dispatch_ref(*_as_torch(pk, m._comp))
    np.testing.assert_array_equal(done.numpy()[pk.valid],
                                  ref_done[pk.valid])
    np.testing.assert_array_equal(counts.numpy(), ref_counts)


def test_plain_version_reads_zero_from_a_producer_at_or_after_its_row():
    """``j <= prod < S`` reads 0 (that row of ``done`` is not written yet),
    the same as ``prod = -1``; ``delta`` is still added."""
    S, E = 4, 1
    z = torch.zeros((S, E), dtype=torch.int32)
    lat = torch.full((S, E), 3, dtype=torch.int32)
    lut = torch.ones((1, 2), dtype=torch.bool)
    delta = torch.full((S, E, 1), 5, dtype=torch.int32)
    valid = torch.ones((S, E), dtype=torch.bool)
    none = torch.full((S, E, 1), -1, dtype=torch.int32)
    for prod in ([[0], [3], [2], [3]], [[2], [1], [3], [3]]):
        prod = torch.tensor(prod, dtype=torch.int32)[:, :, None]
        done, counts = wd.wave_dispatch_ref(z, z, lat, z, valid, prod,
                                            delta, lut)
        want, _ = wd.wave_dispatch_ref(z, z, lat, z, valid, none, delta, lut)
        assert done.flatten().tolist() == want.flatten().tolist() == [8] * 4
        assert counts.tolist() == [[2, 2]]


def _scalar_recurrence(issue, mask_id, lat, blk, valid, prod, delta, lut):
    """The kernel's semantics (the header of ``csrc/wave_dispatch.cu``),
    one lane and one row at a time, in Python integers wrapped to int32."""
    def wrap(x):
        return (x + 2**31) % 2**32 - 2**31
    issue, mask_id, lat, blk, valid, prod, delta, lut = (
        t.numpy().tolist() for t in (issue, mask_id, lat, blk, valid, prod,
                                     delta, lut))
    S, E, P = len(issue), len(issue[0]), len(lut[0])
    done = [[0] * E for _ in range(S)]
    counts = []
    for e in range(E):
        pf, cnt = [0] * P, [0] * P
        for j in range(S):
            ready = issue[j][e]
            for src, d in zip(prod[j][e], delta[j][e]):
                v = done[src][e] if 0 <= src < j else 0
                ready = max(ready, wrap(v + d))
            allowed = lut[mask_id[j][e]]
            tmin, _, best = min(
                (max(ready, pf[p]) if allowed[p] else 2**31 - 1, cnt[p], p)
                for p in range(P))
            if valid[j][e]:
                done[j][e] = wrap(tmin + lat[j][e])
                pf[best] = wrap(tmin + blk[j][e])
                cnt[best] += 1
        counts.append(cnt)
    return done, counts


@pytest.mark.parametrize("label,seed,S,E,R,P,M,kw", card_wave.CASES,
                         ids=[c[0] for c in card_wave.CASES])
def test_plain_version_equals_scalar_recurrence_on_synthetic_waves(
        label, seed, S, E, R, P, M, kw):
    """The synthetic waves the card tests hold the kernel to (far and
    forward producers, every port width, wrapped sums, the sentinel, LUT
    rows of no port): the plain version equals a scalar restatement of the
    kernel's semantics."""
    args = card_wave.synthetic_wave(seed, S, E, R, P, M, **kw)
    done, counts = wd.wave_dispatch_ref(*args)
    want_done, want_counts = _scalar_recurrence(*args)
    assert done.tolist() == want_done
    assert counts.tolist() == want_counts


# ---------------------------------------------------------------------------
# the port's own wave-execution seams
# ---------------------------------------------------------------------------


def test_buffer_reuse_with_narrower_read_width():
    """A reused bucket buffer whose previous occupant had a wider read
    width must not leak stale producer columns into a narrower lane."""
    ra, ri, pa, pi = _sim("sim_skl")
    m = _port_machine(pa, pi)
    scalar = RSim(ra, ri)
    wave_a = [[RInstr("SETC_R8", {"op1": f"R{i + 1}"}),
               RInstr("ADD_R64_R64",
                      {"op1": f"R{i + 8}", "op2": f"R{i + 1}"})] * 24
              for i in range(6)]
    wave_b = wave_a[:1] + \
        [[RInstr("BSWAP_R64", {"op1": f"Q{lane}_{j}"}) for j in range(24)]
         for lane in range(5)]
    for wave in (wave_a, wave_b, wave_b):   # later passes reuse slots
        got = m.run_batch(_port_codes(wave))
        for c, code in zip(got, wave):
            ref = scalar.run(list(code))
            assert c.cycles == ref.cycles and c.port_uops == ref.port_uops
    ring = next(iter(m._device._rings.values()))
    assert len(ring) == 1 and not ring[0].leased   # one slot, reused


def test_slot_leased_until_extraction():
    _, _, pa, pi = _sim("sim_skl")
    dev = p_bs._DeviceExec(_port_machine(pa, pi)._comp, "torch", "cpu")
    s1 = dev.acquire(8, 8, 1)
    s2 = dev.acquire(8, 8, 1)
    assert s2 is not s1 and s1.leased and s2.leased
    s1.release()
    assert dev.acquire(8, 8, 1) is s1


def test_thin_chunks_route_to_the_scalar_oracle():
    ra, ri, pa, pi = _sim("sim_skl")
    body = independent_seq(r_isa.TEST_ISA["ADD_R64_R64"], RegPool(), 3)
    codes = [body * 10, body * 110]
    thin = _port_machine(pa, pi, min_lanes=4)
    got = thin.run_batch(_port_codes(codes))
    assert thin._scalar is not None and thin.device_stats() == {}
    forced = _port_machine(pa, pi, min_lanes=1)
    got2 = forced.run_batch(_port_codes(codes))
    assert forced._scalar is None
    assert forced.device_stats()["kernel_calls"] >= 1
    assert _counters(got) == _counters(got2) == _counters(
        RSim(ra, ri).run_batch(codes))


def test_device_stats_shape_and_lowering_cache():
    _, _, pa, pi = _sim("sim_skl")
    m = _port_machine(pa, pi)
    codes = _port_codes(_interesting_wave(r_isa.TEST_ISA))
    cold = _counters(m.run_batch(codes))
    st = m.device_stats()
    assert set(st) >= {"compiles", "kernel_calls", "buckets", "per_device"}
    assert st["compiles"] == 0            # the plain version loads nothing
    assert st["per_device"]["cpu"]["kernel_calls"] == st["kernel_calls"] > 0
    assert m.degraded_stats() == {}
    misses = m.lowering_stats["misses"]
    assert misses > 0
    assert _counters(m.run_batch(codes)) == cold
    assert m.lowering_stats["misses"] == misses


def test_simmachine_routes_waves_to_the_port_backend():
    ra, ri, pa, pi = _sim("sim_hsw")
    codes = _interesting_wave(r_isa.TEST_ISA)[:10]
    m = PSim(pa, pi, backend="torch", device="cpu")
    got = _counters(m.run_batch(_port_codes(codes)))
    assert m._batch.backend == "torch"
    assert m._batch.device == torch.device("cpu")
    assert got == _counters(RSim(ra, ri).run_batch(codes))


def test_simmachine_hands_launched_args_to_its_backend():
    _, _, pa, pi = _sim("sim_hsw")
    codes = _port_codes(_interesting_wave(r_isa.TEST_ISA)[:10])
    m = PSim(pa, pi, backend="torch", device="cpu", min_lanes=1)
    m.launched_args = kept = []
    m.run_batch(codes)
    assert m._batch.launched_args is kept
    assert len(kept) == m.device_stats()["kernel_calls"] > 0


def test_kernel_inputs_are_the_launched_chunks():
    """``launched_args`` keeps the argument tuple of every chunk
    ``run_batch`` launches, in the kernel's layout, and no later chunk
    overwrites them; on CPU tensors the wrapper runs the plain version on
    them and counts no launch."""
    _, _, pa, pi = _sim("sim_skl")
    codes = _port_codes(_interesting_wave(r_isa.TEST_ISA))
    m = _port_machine(pa, pi)
    m.launched_args = []
    got = m.run_batch(codes)
    chunks = m.launched_args
    assert len(chunks) == m.device_stats()["kernel_calls"] > 1
    snapshot = [tuple(a.clone() for a in args) for args in chunks]
    assert _counters(m.run_batch(codes)) == _counters(got)
    assert len(chunks) == m.device_stats()["kernel_calls"]
    before = wd.launches
    for args, kept in zip(chunks, snapshot):
        assert all(torch.equal(a, b) for a, b in zip(args, kept))
        issue, valid, prod, lut = args[0], args[4], args[5], args[7]
        assert issue.dtype == torch.int32 and issue.is_contiguous()
        assert prod.shape[:2] == issue.shape == valid.shape
        assert torch.equal(lut, m._comp.device_mask_table(lut.device))
        done, counts = wd.wave_dispatch(*args)
        ref_done, ref_counts = wd.wave_dispatch_ref(*args)
        assert torch.equal(done, ref_done) and torch.equal(counts, ref_counts)
        assert int(counts.sum()) > 0
    assert wd.launches == before
    assert all(not s.leased for ring in m._device._rings.values()
               for s in ring)


def test_device_stats_report_kernel_time_only_after_a_traced_wave():
    """The executor's telemetry has the reference's keys: ``kernel_ns``
    (kernel ns per ``device:<id>`` track) and ``stragglers`` appear only
    once a traced wave has run, on the reference's ``jax`` backend and the
    port's ``torch`` backend alike."""
    pytest.importorskip("jax")
    from repro.obs import tracer as r_obs
    from repro_torch.obs import tracer as p_obs
    ra, ri, pa, pi = _sim("sim_skl")
    codes = _interesting_wave(r_isa.TEST_ISA)
    ref = r_bs.BatchSimMachine(ra, ri, backend="jax", min_lanes=1)
    port = _port_machine(pa, pi)
    old = r_obs.get_tracer(), p_obs.get_tracer()
    try:
        r_obs.set_tracer(r_obs.Tracer(enabled=False))
        p_obs.set_tracer(p_obs.Tracer(enabled=False))
        ref.run_batch(codes)
        port.run_batch(_port_codes(codes))
        r_off, p_off = ref.device_stats(), port.device_stats()
        assert set(p_off) == set(r_off)
        assert not {"kernel_ns", "stragglers"} & set(p_off)
        r_obs.set_tracer(r_obs.Tracer(enabled=True))
        p_obs.set_tracer(p_obs.Tracer(enabled=True))
        ref.run_batch(codes)
        port.run_batch(_port_codes(codes))
        r_on, p_on = ref.device_stats(), port.device_stats()
        kernel_spans = [e for e in p_obs.get_tracer().events()
                        if e["name"] == "wave.kernel"]
    finally:
        r_obs.set_tracer(old[0])
        p_obs.set_tracer(old[1])
    assert set(p_on) == set(r_on) == set(r_off) | {"kernel_ns", "stragglers"}
    assert set(p_on["stragglers"]) == set(r_on["stragglers"])
    for stats in (r_on, p_on):
        assert len(stats["kernel_ns"]) == 1
        (track, ns), = stats["kernel_ns"].items()
        assert track.startswith("device:")
        assert isinstance(ns, int) and ns > 0
        assert list(stats["stragglers"]["ewma_s"]) == [track]
        assert stats["stragglers"]["flagged"] == []
    assert list(p_on["kernel_ns"]) == ["device:cpu"]
    assert len(kernel_spans) == p_on["kernel_calls"] - p_off["kernel_calls"]
