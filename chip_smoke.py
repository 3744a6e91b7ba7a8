"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the wave-dispatch kernel from ``src/repro_torch/csrc`` with nvcc,
holds it bit for bit against its plain PyTorch version on the card, then
drives the port's main path — a ``Campaign`` over the full ``TEST_ISA`` on
all three simulated uarches with the ``cuda`` backend, exported with
``model_io`` — and checks that its XML and JSON are byte-identical to the
same campaign on the ``torch`` backend on the CPU.  Every phase prints a
line; any failure exits non-zero and prints no result.  The last two lines
are the kernel report and the device line, both JSON.

Imports nothing of jax and nothing of the reference package ``repro``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
# 32-bit rate, the one that applies to the kernel's int32 scalar arithmetic
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def log(*parts):
    print(*parts, flush=True)


def require(cond, what):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false — this "
                 "script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}: {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from repro_torch.kernels import wave_dispatch as wd
    t0 = time.perf_counter()
    wd.load_library()
    nvcc = "cached" if wd.build_seconds is None else \
        f"nvcc {wd.build_seconds:.2f} s"
    log(f"[build] wave_dispatch built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({nvcc})")
    for line in wd.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def kernel_vs_plain(args):
    """Launch the kernel and its plain version on the same card inputs;
    both outputs must agree bit for bit (``done`` on valid rows, where the
    two also agree that every other row is 0, and ``counts``)."""
    from repro_torch.kernels import wave_dispatch as wd
    done, counts = wd.wave_dispatch(*args)
    torch.cuda.synchronize()
    ref_done, ref_counts = wd.wave_dispatch_ref(*args)
    torch.cuda.synchronize()
    if not (torch.equal(done, ref_done) and torch.equal(counts, ref_counts)):
        bad = int((done != ref_done).sum()) + int((counts != ref_counts)
                                                   .sum())
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain "
                         f"version on {bad} cells, shape "
                         f"{tuple(done.shape)}")
    return 0 if done.numel() == 0 else int((done - ref_done).abs().max())


def _wide(P):
    from repro_torch.core.isa import GPR, ISA, InstrSpec, op
    from repro_torch.core.simulator import Instr
    from repro_torch.core.uarch import UArch, beh, uop
    ports = [f"p{i:02d}" for i in range(P)]
    b = {"TIEW": beh(uop(frozenset(ports), ("op2",), ("op1",))),
         "TIEN": beh(uop(frozenset(ports[:2]), ("op2",), ("op1",)))}
    ua = UArch(f"sim_wide{P}", tuple(ports), 8, b, overhead_cycles=0)
    ops = (op("op1", GPR, "w"), op("op2", GPR, "r"))
    isa = ISA([InstrSpec("TIEW", "TIEW", ops), InstrSpec("TIEN", "TIEN", ops)])
    codes = []
    for reps in (1, 3, 11):
        codes.append([Instr("TIEW", {"op1": f"R{i}", "op2": f"R{i + 40}"})
                      for i in range(3 * P)] * reps)
        codes.append([Instr(("TIEW", "TIEN")[i % 2],
                            {"op1": f"R{i}", "op2": f"R{i + 40}"})
                      for i in range(2 * P)] * reps)
    return ua, isa, codes


def _interesting_wave(isa):
    from repro_torch.core.machine import RegPool, independent_seq
    from repro_torch.core.simulator import Instr
    codes = []
    for spec in ("ADD_R64_R64", "MOV_R64_R64", "XOR_R64_R64", "DIV_R64",
                 "SHLD_R64_R64_I8", "MOV_M64_R64", "AESDEC_X_X",
                 "MOVQ2DQ_X_X", "ADC_R64_R64", "MUL_R64", "PCMPGTQ_X_X",
                 "PAUSE", "ADD_R64_M64"):
        body = independent_seq(isa[spec], RegPool(), 3)
        codes += [body * 10, body * 110]
    codes += [[Instr("DIV_R64", {"op1": "R0", "op2": "R1"}, "high")] * 15,
              [Instr("SETC_R8", {"op1": "R1"}),
               Instr("ADD_R64_R64", {"op1": "R2", "op2": "R1"})] * 35,
              [Instr("MOV_M64_R64", {"mem": "RB0", "op1": "R1"}),
               Instr("MOV_R64_M64", {"op1": "R1", "mem": "RB0"})] * 20]
    return codes


def _random_wave(seed):
    import random

    from repro_torch.core.simulator import Instr
    from repro_torch.core.uarch import random_uarch_and_isa
    ua, isa, truth = random_uarch_and_isa(seed)
    rng = random.Random(seed + 100)
    names = list(truth)
    codes = []
    for _ in range(12):
        body = [Instr(rng.choice(names), {"op1": f"R{rng.randint(0, 5)}",
                                          "op2": f"R{rng.randint(0, 5)}"})
                for _ in range(rng.randint(1, 5))]
        codes.append(body * rng.choice([1, 3, 10, 37, 110]))
    return ua, isa, codes


def phase_kernel_checks():
    """The kernel against its plain version on the card, on waves packed
    by the port exactly as run_batch packs them."""
    from repro_torch.core.batch_sim import BatchSimMachine
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.machine import RegPool, independent_seq
    from repro_torch.core.simulator import Instr, SimMachine
    from repro_torch.core.uarch import SIM_SKL, SIM_UARCHES
    from repro_torch.kernels import wave_dispatch as wd

    def check(label, ua, isa, codes):
        """Run the wave through ``run_batch``; hold every launch's own
        inputs against the plain version, and the wave's results against
        the scalar oracle."""
        m = BatchSimMachine(ua, isa, backend="cuda", min_lanes=1)
        m.launched_args = []
        results = m.run_batch(codes)
        shapes = []
        for args in m.launched_args:
            kernel_vs_plain(args)
            shapes.append(tuple(args[5].shape))
        scalar = SimMachine(ua, isa)
        for got, code in zip(results, codes):
            ref = scalar.run(list(code))
            require((got.cycles, got.port_uops) ==
                    (ref.cycles, ref.port_uops),
                    f"{label}: kernel result differs from the scalar "
                    f"oracle on {code[:3]}")
        log(f"[kernel] {label}: equal on {len(shapes)} chunk(s) "
            f"(S, E, R) = {shapes}")

    for name, ua in SIM_UARCHES.items():
        check(f"interesting wave on {name}", ua, TEST_ISA,
              _interesting_wave(TEST_ISA))
    for P in (18, 32):
        check(f"{P}-port tie wave", *_wide(P))
    for seed in (0, 1, 2, 3):
        ua, isa, codes = _random_wave(seed)
        check(f"random_uarch_and_isa({seed})", ua, isa, codes)
    body = independent_seq(TEST_ISA["IMUL_R64_R64"], RegPool(), 4)
    check("ragged wave", SIM_SKL, TEST_ISA,
          [body * 1, body * 37, [], body * 110,
           [Instr("ADD_R64_R64", {"op1": "R0", "op2": "R1"})], body * 10])
    # empty waves: no rows, and no lanes
    lut = torch.ones((1, 8), dtype=torch.bool, device="cuda")
    for S, E in ((0, 8), (8, 0)):
        z = torch.zeros((S, E), dtype=torch.int32, device="cuda")
        p = torch.full((S, E, 1), -1, dtype=torch.int32, device="cuda")
        kernel_vs_plain((z, z, z, z, z.bool(), p, p.clone(), lut))
    log("[kernel] empty waves (S=0, E=0): equal")
    # a reused buffer: wave B lands in wave A's slot, over A's stale rows
    # and with a narrower read width in most lanes
    wave_a = [[Instr("SETC_R8", {"op1": f"R{i + 1}"}),
               Instr("ADD_R64_R64", {"op1": f"R{i + 8}",
                                     "op2": f"R{i + 1}"})] * 24
              for i in range(6)]
    wave_b = wave_a[:1] + [[Instr("BSWAP_R64", {"op1": f"Q{lane}_{j}"})
                            for j in range(24)] for lane in range(5)]
    m = BatchSimMachine(SIM_SKL, TEST_ISA, backend="cuda", min_lanes=1)
    m.run_batch(wave_a)
    m.launched_args = []
    scalar = SimMachine(SIM_SKL, TEST_ISA)
    for _ in range(2):
        for got, code in zip(m.run_batch(wave_b), wave_b):
            ref = scalar.run(list(code))
            require((got.cycles, got.port_uops) ==
                    (ref.cycles, ref.port_uops),
                    "reused buffer: result differs from the scalar oracle")
    ring = list(m._device._rings.values())
    require(len(ring) == 1 and len(ring[0]) == 1
            and len(m.launched_args) == 2,
            "wave B did not reuse wave A's buffer slot")
    args = m.launched_args[0]
    kernel_vs_plain(args)
    log("[kernel] reused buffer with stale rows and narrower R: equal")
    # stale garbage in every invalid row must be gated off
    g = torch.Generator(device="cuda").manual_seed(13)
    issue, mask, lat, blk, valid, prod, delta, lut = args
    inv = ~valid
    S = issue.shape[0]

    def junk(t, lo, hi):
        r = torch.randint(lo, hi, t.shape, generator=g, device="cuda",
                          dtype=torch.int32)
        m_ = inv if t.dim() == 2 else inv[..., None].expand_as(t)
        return torch.where(m_, r, t)
    kernel_vs_plain((junk(issue, 0, 10**6), junk(mask, 0, lut.shape[0]),
                     junk(lat, 0, 99), junk(blk, 0, 99), valid,
                     junk(prod, -1, S), junk(delta, 0, 9), lut))
    log("[kernel] random garbage in invalid rows: equal")
    require(wd.launches > 0, "the checks never launched the kernel")


def phase_main_path():
    from repro_torch.core import model_io
    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.kernels import wave_dispatch as wd

    def export(res, name):
        model = res.models[name]
        model.run_seconds = 0.0
        return model_io.to_xml(model, TEST_ISA), model_io.to_json(model)

    machines = [SimMachine(ua, TEST_ISA, backend="cuda")
                for ua in SIM_UARCHES.values()]
    for m in machines:    # keep every launch's inputs for phase_main_chunks
        m.launched_args = []
    torch.cuda.synchronize()
    wd.launches = 0
    t0 = time.perf_counter()
    res = Campaign().run(machines, TEST_ISA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wd.launches
    log(f"[main] Campaign over {len(TEST_ISA)} TEST_ISA variants on "
        f"{len(machines)} uarches, cuda backend: {wall:.2f} s wall, "
        f"{launches} kernel launches")
    require(launches > 0, "the main path never launched the kernel")
    require(res.quarantined == 0, f"quarantined: {res.quarantine}")
    calls = 0
    for m in machines:
        st = m.device_stats()
        require(st["backend"] == "cuda" and st["kernel_calls"] > 0,
                f"{m.name} ran no kernel call on the cuda backend")
        require(st["compiles"] <= 1, f"{m.name}: {st['compiles']} loads")
        require(m.degraded_stats() == {},
                f"{m.name} degraded: {m.degraded_stats()}")
        calls += st["kernel_calls"]
        log(f"[main] {m.name}: {st['kernel_calls']} kernel calls, "
            f"{len(res.models[m.name].instructions)} instructions, "
            f"buckets up to {max(st['buckets'])}")
    require(calls == launches, f"{calls} kernel calls vs {launches} launches")

    t0 = time.perf_counter()
    cpu = Campaign().run([SimMachine(ua, TEST_ISA, backend="torch",
                                     device="cpu")
                          for ua in SIM_UARCHES.values()], TEST_ISA)
    cpu_wall = time.perf_counter() - t0
    for name in SIM_UARCHES:
        xml, js = export(res, name)
        cxml, cjs = export(cpu, name)
        require(xml == cxml, f"{name}: XML differs from the CPU torch backend")
        require(js == cjs, f"{name}: JSON differs from the CPU torch backend")
        log(f"[main] {name}: XML ({len(xml)} bytes) and JSON "
            f"({len(js)} bytes) byte-identical to the CPU torch backend")
    log(f"[main] CPU torch-backend campaign: {cpu_wall:.2f} s wall")
    return machines, wall, launches


def _bound_ms(args):
    """Least time for one call on these inputs: the bytes the function
    needs over HBM, or the int32 operations it needs over the card's
    32-bit scalar rate; the larger of the two.  The work depends on the
    data, so only what this chunk needs is counted: the ``valid`` plane,
    ``done`` and ``counts`` and the LUT in full; issue/mask/lat/blk once
    per valid row; a prod/delta pair only where a valid row really reads
    (prod >= 0 or delta != 0), not the bucket's padded R columns; and per
    valid row only the ports its mask allows."""
    issue, mask, lat, blk, valid, prod, delta, lut = args
    S, E = issue.shape
    M, P = lut.shape
    rows = int(valid.sum())
    reads = int((((prod >= 0) | (delta != 0)) & valid[..., None]).sum())
    allowed = int(lut.sum(1, dtype=torch.int64)[mask.long()][valid].sum())
    nbytes = (S * E + M * P            # valid, LUT (bool)
              + 4 * (S * E + E * P)    # done, counts
              + 16 * rows + 8 * reads)
    # an add and a max per read, a max with issue per row, a max and two
    # compares per allowed port, and 3 per row to retire (done, port_free,
    # count)
    ops = 2 * reads + 4 * rows + 3 * allowed
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_ms(fn, args, reps):
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_main_chunks(machines, launches):
    """Every chunk the main path launched, on the very inputs it was
    launched with, held against the plain version and timed once (their
    sum is the kernel's device time over the campaign); the largest chunk
    (by S x E) and the longest (by S) timed over repeated launches."""
    from repro_torch.kernels import wave_dispatch as wd
    largest = longest = None
    n, max_err, total_ms = 0, 0, 0.0
    for m in machines:
        for args in m.launched_args:
            max_err = max(max_err, kernel_vs_plain(args))
            total_ms += _time_ms(wd.wave_dispatch, args, reps=1)
            n += 1
            S, E = args[0].shape
            if largest is None or S * E > largest[0]:
                largest = (S * E, args, m.name)
            if longest is None or S > longest[0]:
                longest = (S, args, m.name)
    log(f"[kernel] all {n} main-path chunks: kernel equal to the plain "
        f"version; kernel device time summed over them {total_ms:.3f} ms")
    require(n == launches, f"{n} chunks kept vs {launches} launches")
    out = {}
    for label, (_, args, name) in (("largest", largest),
                                   ("longest", longest)):
        S, E, R = args[5].shape
        M, P = args[7].shape
        ms = _time_ms(wd.wave_dispatch, args, reps=20)
        plain_ms = _time_ms(wd.wave_dispatch_ref, args, reps=1)
        bound_ms, bound_by = _bound_ms(args)
        log(f"[kernel] {label} main-path chunk ({name}, S={S} E={E} R={R} "
            f"M={M} P={P}, {int(args[4].sum())} of {S * E} rows valid): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by})")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "shape": [S, E, R, M, P]}
    out["max_abs_err"] = max_err
    out["campaign_kernel_ms"] = total_ms
    return out


def phase_breakdown():
    """The main path once more, on fresh machines, with the port's span
    tracer on and torch.profiler recording the card: host time per wave
    phase (summed over the campaign's worker threads) and the device's
    busy share of the campaign wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.obs import tracer as obs

    prev = obs.set_tracer(obs.Tracer(enabled=True))
    try:
        machines = [SimMachine(ua, TEST_ISA, backend="cuda")
                    for ua in SIM_UARCHES.values()]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            Campaign().run(machines, TEST_ISA)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = obs.get_tracer().events()
    finally:
        obs.set_tracer(prev)
    spans: dict = {}
    for ev in events:
        if ev["ph"] == "X" and ev["name"].startswith("wave."):
            spans[ev["name"]] = spans.get(ev["name"], 0) + ev["dur"]
    log(f"[breakdown] traced campaign wall {wall:.3f} s; host thread-seconds "
        "per span: " + ", ".join(f"{k} {v / 1e9:.3f}"
                                 for k, v in sorted(spans.items())))
    device_us: dict = {}
    for item in prof.key_averages():
        us = getattr(item, "self_device_time_total", None)
        if us is None:
            us = getattr(item, "self_cuda_time_total", 0)
        if us:
            device_us[item.key] = us
    busy = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    log(f"[breakdown] device busy {busy:.4f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.2f}%); by kernel: " + "; ".join(
            f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top)
        if busy else "[breakdown] the profiler recorded no device time: "
        "device busy share not measured")


def main():
    smi = phase_device()
    phase_build()
    phase_kernel_checks()
    machines, wall, launches = phase_main_path()
    timing = phase_main_chunks(machines, launches)
    phase_breakdown()
    big = timing["largest"]
    report = {"kernels": [{
        "name": "wave_dispatch", "route": "cuda",
        "source": "src/repro_torch/csrc/wave_dispatch.cu",
        "replaces": "src/repro/core/batch_sim.py:1714",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "shape_SERMP": big["shape"],
        "longest_chunk": timing["longest"],
        "campaign_kernel_ms": timing["campaign_kernel_ms"],
        "campaign_wall_s": wall}]}
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
