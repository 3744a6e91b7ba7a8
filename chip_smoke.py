"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two kernel libraries from ``src/repro_torch/csrc`` with
nvcc, in parallel, and drives its two paths on the card:

* **characterize -> export.**  The wave-dispatch kernel is held bit for
  bit against its plain PyTorch version on the card; then a ``Campaign``
  over the full ``TEST_ISA`` on all three simulated uarches runs with the
  ``cuda`` backend, exported with ``model_io``, and its XML and JSON must be
  byte-identical to the same campaign on the ``torch`` backend on the CPU.
* **hardware characterization.**  The four unit blockers (tensor cores,
  FP32 pipe, MUFU, HBM) are held against their plain versions on the card
  at the reference's default sizes and at sizes that fill the card; then
  ``characterize_corpus`` measures the full op corpus (Algorithm 2 in wall
  clock) and ``profile_kernel`` runs each blocker, and a 512x512 f32
  matmul, beside all four blockers.

Every phase prints a line; any failure exits non-zero and prints no
result.  The last three lines are the card's name and power limit, the
kernel report and the device line, both JSON.

Imports nothing of jax and nothing of the reference package ``repro``.
"""
import functools
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.uarch import H100_SXM  # noqa: E402

# f32 products stay f32 on the card (PyTorch's default, stated and required)
torch.backends.cuda.matmul.allow_tf32 = False


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


def _sass_counts(lib_path):
    """Per kernel function of the library: how many HMMA, FFMA and
    MUFU.RSQ instructions its SASS holds (None without cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "FFMA": 0, "MUFU.RSQ": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += line.count(op)
    return counts


def phase_build():
    from repro_torch.kernels import microbench as mb
    from repro_torch.kernels import wave_dispatch as wd
    t0 = time.perf_counter()
    libs = {"wave_dispatch": wd.LIBRARY, "microbench": mb.LIBRARY}
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        futures = [pool.submit(lib.load) for lib in libs.values()]
        for f in futures:
            f.result()
    log(f"[build] {', '.join(libs)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        nvcc = "cached" if lib.build_seconds is None else \
            f"nvcc {lib.build_seconds:.2f} s"
        log(f"[build] {name}: {lib.path.name} ({nvcc})")
        for line in lib.build_log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"[build] {line.strip()}")
    counts = _sass_counts(mb.LIBRARY.path)
    if counts is None:
        log("[build] cuobjdump not found: SASS not inspected")
        return
    need = {"mxu_chain_kernel": "HMMA", "vpu_chain_kernel": "FFMA",
            "sfu_chain_kernel": "MUFU.RSQ"}
    for kernel, op in need.items():
        fns = [f for f in counts if kernel in f]
        require(len(fns) == 1, f"{kernel} not found in the SASS")
        c = counts[fns[0]]
        log(f"[build] SASS {kernel}: " + ", ".join(
            f"{k} {v}" for k, v in c.items()))
        require(c[op] > 0, f"{kernel}'s SASS has no {op}")


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
    # the non-tensor-core 32-bit rate applies to int32 scalar arithmetic
    return _bound(nbytes, ops, H100_SXM["peak_fp32_flops"])


def _bound(nbytes, ops, ops_per_s):
    """The least time (ms) for ``nbytes`` over HBM and ``ops`` at
    ``ops_per_s``: the larger of the two, and which one it is."""
    t_bytes = nbytes / H100_SXM["hbm_bw"] * 1e3
    t_ops = ops / ops_per_s * 1e3
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


# --------------------------------------------------------- unit blockers
UNITS = ("MXU", "VPU", "SFU", "LSU")
# rows of 128 f32 that fill the card: 132 SMs x 2,048 resident threads
FILL_ROWS = H100_SXM["sms"] * 2048 // 128
# rows of 128 f32 whose buffer is past the L2 cache: 2**17 rows, 64 MiB
LSU_FILL_ROWS = 1 << 17
require(LSU_FILL_ROWS * 128 * 4 > H100_SXM["l2_bytes"], "LSU rows fit L2")
SIZES = {
    # the reference's defaults
    "default": {"MXU": {"iters": 64, "tile": 128},
                "VPU": {"iters": 256, "rows": 8},
                "SFU": {"iters": 128, "rows": 8}, "LSU": {"rows": 4096}},
    # rows that fill the card (the MXU chain is one CTA at any size)
    "fill": {"VPU": {"iters": 256, "rows": FILL_ROWS},
             "SFU": {"iters": 128, "rows": FILL_ROWS},
             "LSU": {"rows": LSU_FILL_ROWS}},
    # what profile_kernel runs: the card-filling rows with chains long
    # enough (~0.5 ms a call, predicted) that each call's host launch cost
    # does not hide the device work
    "profile": {"MXU": {"iters": 64, "tile": 128},
                "VPU": {"iters": 1 << 16, "rows": FILL_ROWS},
                "SFU": {"iters": 1 << 13, "rows": FILL_ROWS},
                "LSU": {"rows": 1 << 20}},
}
MXU_ORTH_ATOL = 1e-4


# The stated tolerances (relative; LSU exact).  MXU 1e-5: 3xTF32 on the
# tensor cores against f32 (3.55e-7 measured on the H100).  VPU 1e-6: one
# fused rounding a step against two, on one input value, so the result is
# fixed; 1.18e-7 measured on the H100 at 256 steps and 1.16e-7 at 65,536,
# and one step more or fewer moves the result by far more (checked in
# phase_blockers).  SFU 1e-6: the chain converges to a fixed point.
RTOL = {"MXU": 1e-5, "VPU": 1e-6, "SFU": 1e-6, "LSU": 0.0}


def _library(unit):
    """One PyTorch call that computes the unit's inner function on the same
    inputs, or None: MXU ``multi_dot([a, b, ..., b])`` (the whole chain in
    one call), LSU ``x + 1.0``; no one call runs the VPU and SFU chains of
    dependent elementwise steps."""
    if unit == "MXU":
        return lambda a, b, iters: torch.linalg.multi_dot([a] + [b] * iters)
    if unit == "LSU":
        return lambda x: torch.add(x, 1.0)
    return None


def _bound_blocker(unit, kw):
    """Least time (ms) of one blocker call on the card: each input read
    once, the output written once, over HBM; the operations over the peak
    of the unit that does them (MXU: 2 * tile**3 * iters FLOP at the TF32
    tensor-core peak; VPU: 2 FLOP a step at the FP32 peak; SFU: one rsqrt a
    step at the MUFU rate; LSU: one add an element at the FP32 peak)."""
    if unit == "MXU":
        t, it = kw["tile"], kw["iters"]
        return _bound(3 * t * t * 4, 2 * t ** 3 * it,
                      H100_SXM["peak_tf32_flops"])
    n = kw["rows"] * 128
    if unit == "VPU":
        return _bound(8 * n, 2 * n * kw["iters"], H100_SXM["peak_fp32_flops"])
    if unit == "SFU":
        return _bound(8 * n, n * kw["iters"], H100_SXM["peak_mufu_ops"])
    return _bound(8 * n, n, H100_SXM["peak_fp32_flops"])


def _errors(got, want):
    torch.cuda.synchronize()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return float(diff.max()), float(rel.max())


def phase_blockers():
    """Each blocker's kernel against its plain version on the card, on the
    public blocker's inputs at every size of ``SIZES`` (and the library
    call, where there is one, against the plain version too), and the MXU
    kernel on a random orthogonal, non-symmetric b.  Returns the
    default-size errors."""
    from repro_torch.kernels import microbench as mb
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "allow_tf32 must be False: f32 products stay f32")
    errs = {}
    for label, sizes in SIZES.items():
        for unit, kw in sizes.items():
            if label != "default" and kw == SIZES["default"][unit]:
                continue
            fn, ref = mb.INNER[unit]
            args = mb.blocker_inputs(unit, "cuda", **kw)
            got = fn(*args)
            require(got.is_cuda and bool(torch.isfinite(got).all()),
                    f"{unit} {kw}: kernel output not finite")
            want = ref(*args)
            abs_err, rel_err = _errors(got, want)
            tol = RTOL[unit]
            ok = rel_err <= tol if tol else abs_err == 0.0
            log(f"[blockers] {unit} {label} {kw}: kernel vs plain on the "
                f"card max abs {abs_err:.3e}, max rel {rel_err:.3e} "
                f"(tolerance {'rel %.1e' % tol if tol else 'exact'})")
            require(ok, f"{unit} {kw}: kernel disagrees with its plain "
                    "version")
            if unit == "VPU":
                # a kernel one step short or long must fail the check
                step = float(((want * 1.000001 + 0.5 - want).abs()
                              / want.abs()).min())
                log(f"[blockers] VPU {label}: one more step moves the "
                    f"plain result by rel {step:.3e} at least")
                require(step > 2 * tol, "the VPU tolerance cannot see a "
                        "missing step")
            lib = _library(unit)
            if lib is not None:
                _, lib_rel = _errors(lib(*args), want)
                require(lib_rel <= tol if tol else lib_rel == 0.0,
                        f"{unit} {kw}: the library call computes another "
                        f"function (rel {lib_rel:.3e})")
            if label == "default":
                errs[unit] = abs_err
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    q = np.linalg.qr(rng.standard_normal((128, 128)))[0].astype(np.float32)
    require(float(np.abs(q - q.T).max()) > 0.1, "b is symmetric")
    a, q = torch.from_numpy(a).cuda(), torch.from_numpy(q).cuda()
    abs_err, _ = _errors(mb.mxu_chain(a, q, 64), mb.mxu_chain_ref(a, q, 64))
    log(f"[blockers] MXU on a random orthogonal non-symmetric b (seed 0), "
        f"64 iters: max abs {abs_err:.3e} (tolerance abs "
        f"{MXU_ORTH_ATOL:.0e})")
    require(abs_err <= MXU_ORTH_ATOL, "MXU kernel disagrees on random b")
    return errs


def phase_hardware():
    """The hardware-characterization path on the card: Algorithm 2 over the
    full op corpus, then profile_kernel of each blocker and of
    matmul_512x512_f32 against all four.  The blockers' launch counts are
    set to 0 just before and read just after."""
    from repro_torch.core.hardware import characterize_corpus
    from repro_torch.core.kernel_bench import profile_kernel
    from repro_torch.corpus import build_jit_corpus
    from repro_torch.kernels import microbench as mb
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "allow_tf32 must be False: f32 products stay f32")
    corpus = build_jit_corpus()
    cpu = build_jit_corpus(device="cpu")
    for name, (f, x, _) in corpus.items():
        got = f(x).cpu().float()
        want = cpu[name][0](cpu[name][1]).float()
        rtol = 1e-5 if x.dtype == torch.float32 else 2e-2
        require(got.shape == want.shape and torch.allclose(
            got, want, rtol=rtol, atol=1e-6), f"{name}: card != CPU")
    log(f"[hardware] {len(corpus)} corpus ops equal on the card and the CPU "
        "(rtol 1e-5 f32, 2e-2 bf16)")
    blockers = {u: functools.partial(mb.BLOCKERS[u], **SIZES["profile"][u])
                for u in UNITS}
    torch.cuda.synchronize()
    mb.launches.update(dict.fromkeys(mb.launches, 0))
    t0 = time.perf_counter()
    res = characterize_corpus(corpus)
    t_corpus = time.perf_counter() - t0
    profiles = {u: profile_kernel(f"{u} blocker", blk, blockers)
                for u, blk in blockers.items()}
    f, x, _ = corpus["matmul_512x512_f32"]
    profiles["matmul_512x512_f32"] = profile_kernel(
        "matmul_512x512_f32", lambda: f(x), blockers)
    torch.cuda.synchronize()
    launches = dict(mb.launches)
    log(f"[hardware] characterize_corpus over {len(res)} ops in "
        f"{t_corpus:.2f} s wall; op: latency us, throughput us, GFLOP/s")
    for name, m in res.items():
        require(m.latency_ns >= 0 and m.throughput_ns >= 0, name)
        log(f"[hardware]   {name:20s} {m.latency_ns / 1e3:9.3f} "
            f"{m.throughput_ns / 1e3:9.3f} {m.achieved_gflops:10.2f}")
    log("[hardware] overlap(target, blocker) with blockers "
        + json.dumps(SIZES["profile"]))
    for name, prof in profiles.items():
        require(list(prof.overlap) == list(UNITS) and all(
            np.isfinite(v) for v in prof.overlap.values()), name)
        log(f"[hardware]   {name:20s} alone {prof.alone_ns / 1e3:9.1f} us; "
            + ", ".join(f"{u} {v:+.3f}" for u, v in prof.overlap.items()))
    log(f"[hardware] blocker launches in this phase: {launches}")
    for u in UNITS:
        require(launches[u] > 0, f"the hardware path never launched {u}")
    return launches, {k: {"alone_ns": p.alone_ns, "overlap": p.overlap}
                      for k, p in profiles.items()}


# a spin of ~0.1 s at the H100's ~1.98 GHz: longer than the host takes to
# queue 200 wrapper calls (~0.03 ms each)
SPIN_CYCLES = 200_000_000


def _device_ms(fn, args, reps, bound_ms):
    """The card's time per launch with the launches back to back: they are
    queued behind a spin kernel (``torch.cuda._sleep``), so the card runs
    them with no host gap between them, and CUDA events around them time
    the card alone.  Fails if the spin ended before the host had queued
    them all, or if the time is below the bound."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    require(not start.query(), "the spin ended before the host had queued "
            f"{reps} launches: the time would include host gaps")
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    require(ms >= bound_ms, f"{fn.__name__}: {ms:.6f} ms a launch, below "
            f"its bound {bound_ms:.6f} ms")
    return ms


def phase_blocker_timing():
    """Each blocker's kernel, plain version and (MXU, LSU) library call
    timed with CUDA events on the same card inputs, at the default and the
    card-filling sizes, beside its bound; and the card's time per launch
    with the launches back to back (at small sizes the event time of a call
    is the wrapper's host cost)."""
    from repro_torch.kernels import microbench as mb
    out = {}
    reps = {"MXU": 20, "VPU": 200, "SFU": 200, "LSU": 200}
    for unit in UNITS:
        fn, ref = mb.INNER[unit]
        lib = _library(unit)
        row = {}
        for label in ("default", "fill", "profile"):
            kw = SIZES[label].get(unit)
            if kw is None or (label != "default"
                              and kw == SIZES["default"][unit]):
                continue
            args = mb.blocker_inputs(unit, "cuda", **kw)
            n = reps[unit] if label == "default" else 5
            ms = _time_ms(fn, args, reps=n)
            plain_ms = _time_ms(ref, args, reps=1 if label == "profile"
                                else 3)
            library_ms = None if lib is None else _time_ms(lib, args, reps=n)
            bound_ms, bound_by = _bound_blocker(unit, kw)
            device_ms = _device_ms(fn, args, n, bound_ms)
            row[label] = {"size": kw, "ms": ms, "device_ms": device_ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
            lib_text = "" if library_ms is None else \
                f", library {library_ms:.5f} ms"
            log(f"[timing] {unit} {label} {kw}: kernel {ms:.5f} ms a call "
                f"(device {device_ms:.5f} ms a launch, {n} back to back), "
                f"plain {plain_ms:.5f} ms{lib_text}, bound "
                f"{bound_ms:.7f} ms ({bound_by}), kernel/bound "
                f"{ms / bound_ms:.1f}")
        out[unit] = row
    return out


def main():
    smi = phase_device()
    phase_build()
    phase_kernel_checks()
    machines, wall, launches = phase_main_path()
    timing = phase_main_chunks(machines, launches)
    phase_breakdown()
    errs = phase_blockers()
    blocker_launches, profiles = phase_hardware()
    blocker_times = phase_blocker_timing()
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
    replaces = {"MXU": 27, "VPU": 49, "SFU": 69, "LSU": 89}
    for unit in UNITS:
        d = blocker_times[unit]["default"]
        report["kernels"].append({
            "name": f"{unit.lower()}_blocker", "route": "cuda",
            "source": "src/repro_torch/csrc/microbench.cu",
            "replaces": f"src/repro/kernels/microbench.py:{replaces[unit]}",
            "launches": blocker_launches[unit], "max_abs_err": errs[unit],
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
            "library_ms": d["library_ms"], "device_ms": d["device_ms"],
            "size": d["size"],
            "other_sizes": {k: v for k, v in blocker_times[unit].items()
                            if k != "default"},
            "overlap_as_target": profiles[unit]})
    report["profile_matmul_512x512_f32"] = profiles["matmul_512x512_f32"]
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
