"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's six kernel libraries from ``src/repro_torch/csrc`` with
nvcc, in parallel, runs the jax-free card tests
(``python -m pytest -m cuda tests/test_torch_card_*.py``) against them, and
drives the port's four paths on the card:

* **characterize -> export.**  The wave-dispatch kernel is held bit for
  bit against its plain PyTorch version on the card; then a ``Campaign``
  over the full ``TEST_ISA`` on all three simulated uarches runs with the
  ``cuda`` backend, exported with ``model_io``, and its XML and JSON must be
  byte-identical to the same campaign on the ``torch`` backend on the CPU.
* **predict -> serve -> query.**  The campaign's three models are served
  by ``start_server(predict_backend="cuda")`` to a JSON and a binary
  client (the README's block and 1,024 random blocks a uarch); the
  payloads must be byte-identical across the wires and to the numpy
  backend on the CPU, with device waves served and none routed back.  A
  10,000-block wave runs in process bit-identical to numpy, and
  ``simulate_batch`` on the card equals the CPU machine.  The port-bound
  kernel is then held against its plain version on every wave it served
  and on random, tie, all-zero and near-guard inputs, and timed beside its
  plain version and its bound.
* **hardware characterization.**  The four unit blockers (tensor cores,
  FP32 pipe, MUFU, HBM) are held against their plain versions on the card
  at the reference's default sizes and at sizes that fill the card; then
  ``characterize_corpus`` measures the full op corpus (Algorithm 2 in wall
  clock) and ``profile_kernel`` runs each blocker, and a 512x512 f32
  matmul, beside all four blockers.
* **the op layer** (``kernels/ops.py``).  ``ops.flash_attention``,
  ``ops.rmsnorm`` and ``ops.ssd_scan`` run at the full widths of the
  repo's configs (SmolLM-360M, Zamba2-2.7B, Qwen3-8B, Phi-3-mini-3.8B,
  Mamba2-2.7B), with one backward through ``ops.flash_attention``; then
  each of the three kernels is held against its plain version on the same
  card inputs (and on views: transposed, strided, off 16-byte alignment)
  and timed beside its plain version, one PyTorch call that computes the
  same function (where there is one) and its bound.  The SSD scan's four
  kernels are timed alone as well, and its f32 error is attributed: the
  kernel and the f32 plain version, each against the plain version on
  f64 copies of the inputs.

Every phase prints a line; any failure exits non-zero and prints no
result.  The last three lines are the card's name and power limit, the
kernel report and the device line, both JSON.

Imports nothing of jax and nothing of the reference package ``repro``.
"""
import functools
import json
import os
import re
import shutil
import struct
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
        f"x{torch.cuda.device_count()} ({smi})")
    return smi


def _sass_counts(lib_path):
    """Per kernel function of the library: how many HMMA, HGMMA, FFMA and
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
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0, "MUFU.RSQ": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += line.count(op)
    return counts


def phase_build():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import microbench as mb
    from repro_torch.kernels import port_bound as pb
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.kernels import wave_dispatch as wd
    t0 = time.perf_counter()
    libs = {"wave_dispatch": wd.LIBRARY, "microbench": mb.LIBRARY,
            "flash_attention": fa.LIBRARY, "rmsnorm": rn.LIBRARY,
            "ssd_scan": sd.LIBRARY, "port_bound": pb.LIBRARY}
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
    # flash attention runs its products on the tensor cores (every head dim,
    # both dtypes)
    fns = {f: c for f, c in _sass_counts(fa.LIBRARY.path).items()
           if "flash_fwd_kernel" in f}
    require(len(fns) > 0, "flash_fwd_kernel not found in the SASS")
    for f, c in fns.items():
        require(c["HMMA"] + c["HGMMA"] > 0,
                f"{f}: no HMMA or HGMMA in its SASS")
    log(f"[build] SASS flash_fwd_kernel: {len(fns)} instantiations, HMMA "
        f"{min(c['HMMA'] for c in fns.values())}-"
        f"{max(c['HMMA'] for c in fns.values())}, HGMMA "
        f"{max(c['HGMMA'] for c in fns.values())}")
    # so do the SSD scan's three product kernels; its state pass has no
    # product
    counts = _sass_counts(sd.LIBRARY.path)
    for kernel, products in (("ssd_chunk_state", True), ("ssd_chunk_cb", True),
                             ("ssd_chunk_scan", True),
                             ("ssd_state_pass", False)):
        fns = {f: c for f, c in counts.items() if kernel in f}
        require(len(fns) > 0, f"{kernel} not found in the SASS")
        for f, c in fns.items():
            require((c["HMMA"] > 0) == products,
                    f"{f}: HMMA {c['HMMA']} (products: {products})")
        log(f"[build] SASS {kernel}: {len(fns)} instantiations, HMMA "
            f"{min(c['HMMA'] for c in fns.values())}-"
            f"{max(c['HMMA'] for c in fns.values())}, FFMA "
            f"{min(c['FFMA'] for c in fns.values())}-"
            f"{max(c['FFMA'] for c in fns.values())}")


def phase_card_tests():
    """The ``cuda``-marked pytest cases that need no jax (the jax-free
    ``tests/test_torch_card_*.py``), in a subprocess on this card, with the
    libraries just built.  Fails if pytest fails or passes no test."""
    files = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "tests").glob("test_torch_card_*.py"))
    require(files, "no tests/test_torch_card_*.py")
    cmd = [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
           "-p", "no:cacheprovider", *files]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    passed = re.search(r"(\d+) passed", tail)
    n = int(passed.group(1)) if passed else 0
    log(f"[card-tests] python -m pytest -q -m cuda {' '.join(files)}: "
        f"{tail} (rc {proc.returncode}, {time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or n == 0:
        log(proc.stdout[-6000:])
        log(proc.stderr[-3000:])
    require(proc.returncode == 0, "the card tests failed")
    require(n > 0, "the card tests passed no test")
    return n


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
    return machines, wall, launches, res.models


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
        device_ms = _device_ms(wd.wave_dispatch, args, 20, bound_ms)
        # the kernel walks each block's rows up to its last valid one: the
        # longest walk is the chunk's last row with any valid lane
        rows = torch.arange(S, device=args[4].device)[:, None]
        walk = int(torch.where(args[4], rows, -1).max()) + 1
        log(f"[kernel] {label} main-path chunk ({name}, S={S} E={E} R={R} "
            f"M={M} P={P}, {int(args[4].sum())} of {S * E} rows valid, "
            f"{wd.port_width(P)}-port instance, {wd.rows_per_tile(R, M)} "
            f"rows a tile): kernel {ms:.4f} ms a call (device "
            f"{device_ms:.4f} ms a launch, 20 back to back; {walk} rows "
            f"walked, {device_ms * 1e6 / walk:.1f} ns a step), plain "
            f"{plain_ms:.2f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        out[label] = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "rows_walked": walk, "shape": [S, E, R, M, P]}
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


# ------------------------------------------------------ predict -> serve
README_BLOCK = "IMUL_R64_R64 op1=R0 op2=R1\nADD_R64_R64 op1=R0 op2=R2"
SERVE_SEED = 1234
SERVE_BLOCKS = 1024       # one predict_batch a uarch and wire
WIDE_BLOCKS = 10_000      # one uarch's share of the corpus (README)
SIM_BLOCKS = 256          # simulate-backed blocks a uarch
LOAD_SECONDS = 2.0        # closed-loop load a wire (cached answers)


def _canon(envs):
    """Canonical JSON of response envelopes, trace ids dropped."""
    return json.dumps([{k: v for k, v in e.items() if k != "trace_id"}
                       for e in envs], sort_keys=True)


def _bits(preds):
    """Every float field of every prediction, as float64 bits, and the
    rest of the prediction."""
    return [(struct.pack(f"<{4 + len(p.port_pressure)}d", p.cycles,
                         p.port_bound, p.latency_bound, p.frontend_bound,
                         *p.port_pressure.values()),
             tuple(p.port_pressure), p.bottleneck) for p in preds]


def _quotients(num, den):
    return (num.cpu().double() / den.cpu().double()).numpy()


def port_bound_vs_plain(args):
    """The port-bound kernel and its plain version on the same card
    inputs; their float64 quotients must agree bit for bit (tied ratios
    may come back as different pairs).  Returns the largest absolute
    difference of the quotients (0.0)."""
    from repro_torch.kernels import port_bound as pb
    num, den = pb.port_bound(*args)
    torch.cuda.synchronize()
    rnum, rden = pb.port_bound_ref(*args)
    got, want = _quotients(num, den), _quotients(rnum, rden)
    if not np.array_equal(got.view(np.int64), want.view(np.int64)):
        bad = int((got != want).sum())
        raise SystemExit(f"chip_smoke: port_bound disagrees with its plain "
                         f"version on {bad} rows, shape "
                         f"{tuple(args[0].shape)} x {tuple(args[1].shape)}")
    return float(np.abs(got - want).max()) if len(got) else 0.0


def _port_bound_cases():
    """Random int32 inputs at B x C x S in {1, 31, 32, 4096, 10,000} x
    {1, 11, 32} x {1, 71, 4096} inside the reference's guard, then ties,
    all-zero rows and row totals just below the guard."""
    rng = np.random.default_rng(SERVE_SEED)
    guard = 2 ** 31
    cases = []
    for B in (1, 31, 32, 4096, WIDE_BLOCKS):
        for C in (1, 11, 32):
            for S in (1, 71, 4096):
                size = rng.integers(1, 9, S)
                u = rng.integers(0, 1000, (B, C))
                u[rng.random(B) < 0.1] = 0
                cases.append((u, rng.random((C, S)) < 0.4, size))
    cases.append((np.full((64, 4), 3), np.eye(4), np.ones(4)))
    u = rng.integers(0, 10, (4096, 6))
    u[:, 0] = u[:, 1] = rng.integers(50, 99, 4096)
    mask = rng.random((6, 71)) < 0.4
    size = np.full(71, 8)
    mask[:, 3], size[3] = [1, 0, 0, 0, 0, 0], 1
    mask[:, 40], size[40] = [1, 1, 0, 0, 0, 0], 2
    cases.append((u, mask, size))
    u = rng.integers(0, 1000, (4096, 11))
    u[::2] = 0
    cases.append((u, rng.random((11, 71)) < 0.4, rng.integers(1, 9, 71)))
    size = rng.integers(1, 9, 71)
    cap = (guard - 1) // int(size.max())
    u = np.zeros((4096, 11), np.int64)
    u[:, 0] = cap - np.arange(4096)
    u[::2, :3] = cap // 3
    cases.append((u, rng.random((11, 71)) < 0.4, size))
    out = []
    for u, mask, size in cases:
        require(int(u.sum(1).max()) * int(size.max()) < guard,
                "a port_bound case breaks the guard")
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         .cuda() for a in (u, mask, size)))
    return out


def _serve_session(client, waves):
    """The requests of one client: uarches, health, the README's block
    on every uarch, one predict_batch a uarch.  Every envelope must be
    ok.  Returns the canonical payloads (trace ids dropped) and the
    predict_batch wall times."""
    out = [json.dumps(client.uarches())]
    require(client.health()["status"] == "ok", "health is not ok")
    wall = 0.0
    for ua, blocks in waves.items():
        env = client.predict(ua, README_BLOCK, raw=True)
        require(env["ok"], f"{ua}: README block: {env}")
        out.append(_canon([env]))
        t0 = time.perf_counter()
        envs = client.predict_batch(ua, blocks)
        wall += time.perf_counter() - t0
        require(len(envs) == len(blocks) and all(e["ok"] for e in envs),
                f"{ua}: an envelope of the batch is not ok")
        out.append(_canon(envs))
    return out, wall


def _host_payloads(models, waves):
    """The same requests answered in process by the numpy backend on the
    CPU."""
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.service.batch_predictor import BatchPredictor
    from repro_torch.service.protocol import parse_block, prediction_to_dict
    out = [json.dumps(sorted(models))]
    for ua, blocks in waves.items():
        bp = BatchPredictor(models[ua], TEST_ISA, backend="numpy")
        out.append(_canon([{"ok": True, "uarch": ua,
                            "result": prediction_to_dict(bp.predict(
                                parse_block(README_BLOCK)))}]))
        out.append(_canon([{"ok": True, "uarch": ua,
                            "result": prediction_to_dict(p)}
                           for p in bp.predict_batch(blocks)]))
    return out


def phase_serve(models):
    """predict -> serve -> query on the card: the three models served by
    ``start_server(predict_backend="cuda")`` over a JSON and a binary
    client; the widest wave in process; simulate-backed mode.  Returns
    the port-bound kernel's launches on this path and every wave it
    launched, the widest wave's inputs and the serve numbers."""
    import tempfile

    from repro_torch.core import model_io
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.kernels import port_bound as pb
    from repro_torch.kernels import wave_dispatch as wd
    from repro_torch.service.batch_predictor import BatchPredictor
    from repro_torch.service.client import ServiceClient
    from repro_torch.service.loadgen import run_load
    from repro_torch.service.server import start_server
    from repro_torch.service.workload import random_blocks

    names = sorted(models)
    waves = {ua: random_blocks(models[ua], TEST_ISA, SERVE_BLOCKS,
                               seed=SERVE_SEED) for ua in names}
    fresh = {wire: {ua: random_blocks(models[ua], TEST_ISA, SERVE_BLOCKS,
                                      seed=SERVE_SEED + 1 + i)
                    for ua in names}
             for i, wire in enumerate(("json", "binary"))}
    launched = []
    out = {"wires": {}}
    torch.cuda.synchronize()
    pb.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for ua in names:
            (Path(tmp) / f"{ua}.xml").write_text(
                model_io.to_xml(models[ua], TEST_ISA))
        server = start_server(tmp, predict_backend="cuda")
        try:
            for ua in names:    # keep every launch's inputs
                server.service._predictor(ua)[1].launched_args = launched
            payloads = {}
            for wire in ("json", "auto"):
                with ServiceClient(server.host, server.port,
                                   wire=wire) as c:
                    want = "json" if wire == "json" else "binary"
                    require(c.wire == want, f"wire {wire} negotiated "
                            f"{c.wire}")
                    payloads[want], _ = _serve_session(c, waves)
                    # fresh blocks: nothing in the caches, a cold wave
                    got, cold = _serve_session(c, fresh[want])
                    require(got == _host_payloads(models, fresh[want]),
                            f"{want} wire: fresh payloads differ from the "
                            "numpy backend")
                load = run_load(server.host, server.port, "sim_skl",
                                waves["sim_skl"][:256], wire=want, conns=4,
                                duration_s=LOAD_SECONDS)
                require(load["errors"] == 0, f"loadgen errors: {load}")
                n = SERVE_BLOCKS * len(names)
                out["wires"][want] = {
                    "cold_predict_batch_s": cold,
                    "cold_predictions_per_s": n / cold,
                    "warm_predictions_per_s": load["predictions_per_s"],
                    "loadgen": load}
                log(f"[serve] {want} wire: {n} cold predictions in "
                    f"{cold:.3f} s ({n / cold:.0f}/s); closed loop on "
                    f"cached waves of 256: {json.dumps(load)}")
            require(payloads["json"] == payloads["binary"],
                    "payloads differ between the JSON and binary wires")
            require(payloads["json"] == _host_payloads(models, waves),
                    "served payloads differ from the numpy backend on "
                    "the CPU")
            st = server.service.stats()["predictor"]
            log(f"[serve] predictor stats: {json.dumps(st)}")
            require(st["backend"] == "cuda", f"backend {st['backend']}")
            require(st["device_waves"] > 0, "no device wave was served")
            require(st["device_fallbacks"] == 0,
                    f"{st['device_fallbacks']} device fallbacks")
            out["predictor_stats"] = st
        finally:
            server.close()
    served = pb.launches
    require(served > 0, "serving never launched the port_bound kernel")
    log(f"[serve] {len(names)} uarches x 2 wires: every envelope ok, "
        f"payloads byte-identical across the wires and to the numpy "
        f"backend on the CPU; port_bound launched {served} times")

    # the widest wave: one uarch's share of the corpus, in process
    model = models["sim_skl"]
    blocks = random_blocks(model, TEST_ISA, WIDE_BLOCKS, seed=SERVE_SEED)
    bp = BatchPredictor(model, TEST_ISA, backend="cuda")
    bp.predict_batch(blocks[:64])          # upload the tables first
    bp.launched_args = launched
    launches_before_wide = len(launched)
    host = BatchPredictor(model, TEST_ISA, backend="numpy")
    walls = {"cuda": [], "numpy": []}
    results = {}
    for name in ("cuda", "numpy", "numpy", "cuda"):     # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = (bp if name == "cuda" else host).predict_batch(
            blocks)
        walls[name].append(time.perf_counter() - t0)
    require(_bits(results["cuda"]) == _bits(results["numpy"]),
            "the 10,000-block wave differs from the numpy backend")
    wide_args = launched[-1]
    require(len(launched) == launches_before_wide + 2
            and wide_args[0].shape[1] == len(bp._combos),
            "the widest wave did not launch")
    log(f"[serve] widest wave: {WIDE_BLOCKS} sim_skl blocks, "
        f"{wide_args[0].shape[0]} device rows, C={wide_args[1].shape[0]} "
        f"S={wide_args[1].shape[1]}: cuda {walls['cuda']} s wall, numpy "
        f"{walls['numpy']} s, in turns; bit-identical")
    # the main path's launches end here: the breakdown below is a timing
    # pass, kept out of the count and of the waves held against the plain
    # version
    launches = pb.launches
    bp.launched_args = None
    out["widest"] = {"blocks": WIDE_BLOCKS, "wall_s": walls["cuda"],
                     "numpy_wall_s": walls["numpy"],
                     "breakdown_s": _wave_breakdown(bp, blocks)}

    # simulate-backed mode on every uarch
    before = wd.launches
    for ua in names:
        blk = random_blocks(models[ua], TEST_ISA, SIM_BLOCKS,
                            seed=SERVE_SEED)
        card = BatchPredictor(models[ua], TEST_ISA, machine=SimMachine(
            SIM_UARCHES[ua], TEST_ISA, backend="cuda")).simulate_batch(blk)
        cpu = BatchPredictor(models[ua], TEST_ISA, backend="numpy",
                             machine=SimMachine(SIM_UARCHES[ua], TEST_ISA,
                                                backend="torch",
                                                device="cpu")
                             ).simulate_batch(blk)
        require(card == cpu, f"{ua}: simulate_batch differs from the CPU "
                "machine")
    require(wd.launches > before, "simulate_batch never launched the wave "
            "kernel")
    log(f"[serve] simulate_batch: {SIM_BLOCKS} blocks on each of "
        f"{len(names)} uarches equal to the CPU machine's cycles; "
        f"{wd.launches - before} wave-dispatch launches")
    return launches, launched, wide_args, out


def _wave_breakdown(bp, blocks):
    """Host seconds of the widest wave's parts, each over all its blocks:
    the reference helpers a served wave runs per block, and the device
    call (packing u, the copy up, the kernel, the copy back)."""
    from repro_torch.core.predictor import (_latency_bound, check_block,
                                            port_pressure, sum_usage)
    codes = [list(b) for b in blocks]
    parts = {}
    t0 = time.perf_counter()
    for c in codes:
        check_block(bp.model, c, bp.isa)
    parts["check_block"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sums = {i: sum_usage(bp.model, c) for i, c in enumerate(codes)}
    parts["sum_usage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in codes:
        _latency_bound(bp.model, bp.isa, c)
    parts["latency_bound"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for u, _ in sums.values():
        port_pressure(u)
    parts["port_pressure"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bp._port_bounds(sums)
    torch.cuda.synchronize()
    parts["port_bounds"] = time.perf_counter() - t0
    log("[serve] widest wave, host seconds by part: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    return parts


def phase_serve_kernel(launched, wide_args):
    """The port-bound kernel against its plain version on the card: every
    wave the serve path launched, then random, tie, all-zero and
    near-guard inputs; then the widest wave's launch timed beside its
    plain version and its bound."""
    from repro_torch.kernels import port_bound as pb
    err = 0.0
    for args in launched:
        err = max(err, port_bound_vs_plain(args))
    cases = _port_bound_cases()
    for args in cases:
        err = max(err, port_bound_vs_plain(args))
    log(f"[serve-kernel] port_bound equal to its plain version on "
        f"{len(launched)} served waves and {len(cases)} random and "
        "hand-made inputs")
    u, mask, size = wide_args
    B, C = u.shape
    S = mask.shape[1]
    nbytes = 4 * (B * C + C * S + S + 2 * B)
    # what these inputs need: an add per (row, combo with uops, candidate
    # holding it), and two products and a compare per (row, candidate)
    adds = int(((u != 0).sum(0, dtype=torch.int64)
                * mask.sum(1, dtype=torch.int64)).sum())
    ops = adds + 3 * B * S
    bound_ms, bound_by = _bound(nbytes, ops, H100_SXM["peak_fp32_flops"])
    ms = _time_ms(pb.port_bound, wide_args, reps=200)
    device_ms = _device_ms(pb.port_bound, wide_args, 200, bound_ms)
    plain_ms = _time_ms(pb.port_bound_ref, wide_args, reps=3)
    log(f"[serve-kernel] widest wave B={B} C={C} S={S}: kernel {ms:.4f} ms "
        f"a call (device {device_ms:.4f} ms a launch, 200 back to back), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} operations)")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "shape_BCS": [B, C, S]}

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
    # rows that fill the card (the MXU chain runs one CTA a 16-row block:
    # 8 CTAs at the reference's tile of 128, whatever the iterations)
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
    tile = SIZES["default"]["MXU"]["tile"]
    ctas = mb.mxu_chain_ctas(tile)
    log(f"[blockers] MXU kernel at tile {tile}: {ctas} CTAs, one a 16-row "
        "block")
    require(ctas == tile // 16, "the MXU kernel runs one CTA a 16-row block")
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


# ------------------------------------------------------------- op layer
# The stated tolerances (each is both atol and rtol, as tests/test_kernels.py
# states them for the reference's Pallas kernels): flash attention 2e-5 f32,
# 2e-2 bf16; rmsnorm 1e-5 f32, 2e-2 bf16; SSD 1e-4 f32, 5e-2 bf16; the
# chunked SSD against the sequential recurrence 1e-3; flash attention's
# gradients 1e-4.
OPS_TOL = {"flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
           "rmsnorm": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
           "ssd_scan": {torch.float32: 1e-4, torch.bfloat16: 5e-2}}
# At full width a causal row averages v over up to 4096 keys, so |out| is
# about 0.5 / sqrt(i + 1), near 0.01 on late rows: an atol of 2e-2 could not
# see a row left at zero.  Flash attention in bf16 is held there to atol 1e-3
# and rtol 2e-2 (bf16 rounds the output relatively: one ulp is 2**-8 of it).
FULL_WIDTH_ATOL = {("flash_attention", torch.bfloat16): 1e-3}
SSD_SEQ_TOL = 1e-3
GRAD_TOL = 1e-4
OPS_SEED = 0


def _ops_cases():
    """The op layer's main path: each kernel at the full widths of the
    repo's configs.  Flash attention (label, B, Hq, Hkv, Sq, Sk, D, causal,
    dtype); rmsnorm (label, rows, d, dtype); SSD (label, b, s, h, p, n, g,
    chunk, dtype).  The first case of each kernel is its headline."""
    from repro_torch.configs.base import load_config
    bf16, f32 = torch.bfloat16, torch.float32
    smol = load_config("smollm_360m")
    zamba = load_config("zamba2_2_7b")
    qwen = load_config("qwen3_8b")
    phi3 = load_config("phi3_mini_3_8b")
    mamba = load_config("mamba2_2_7b")

    flash = [("smollm_360m", 4, smol.num_heads, smol.num_kv_heads, 4096,
              4096, smol.head_dim, True, bf16),
             ("smollm_360m", 4, smol.num_heads, smol.num_kv_heads, 4096,
              4096, smol.head_dim, True, f32),
             ("zamba2_2_7b shared block", 1, zamba.num_heads,
              zamba.num_kv_heads, 2048, 2048, zamba.head_dim, True, bf16),
             ("zamba2_2_7b shared block", 1, zamba.num_heads,
              zamba.num_kv_heads, 2048, 2048, zamba.head_dim, True, f32),
             ("qwen3_8b", 1, qwen.num_heads, qwen.num_kv_heads, 2048, 2048,
              qwen.head_dim, False, f32),
             ("phi3_mini_3_8b", 1, phi3.num_heads, phi3.num_kv_heads, 2048,
              2048, phi3.head_dim, True, bf16),
             ("cross-length", 2, 4, 2, 256, 512, 64, False, f32)]
    rms = [("smollm_360m residual", 4 * 4096, smol.d_model, bf16),
           ("smollm_360m residual", 4 * 4096, smol.d_model, f32),
           ("mamba2_2_7b residual", 2 * 4096, mamba.d_model, bf16),
           ("ragged rows", 4093, smol.d_model, bf16),
           ("ragged rows, odd width (one element a lane)", 4093, 1001, f32)]
    m = (mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state,
         mamba.ssm_groups, mamba.ssm_chunk)
    z = (zamba.ssm_heads, zamba.ssm_headdim, zamba.ssm_state,
         zamba.ssm_groups, zamba.ssm_chunk)
    ssd = [("mamba2_2_7b", 2, 4096, *m, f32),
           ("mamba2_2_7b", 2, 4096, *m, bf16),
           ("zamba2_2_7b", 2, 4096, *z, f32)]
    # held against the sequential recurrence: Mamba2 width, two chunks
    ssd_seq = ("mamba2_2_7b, 2 chunks", 2, 2 * mamba.ssm_chunk, *m, f32)
    return flash, rms, ssd, ssd_seq


def _normal(gen, shape, dtype, scale=0.5):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        dtype)


def _flash_inputs(gen, case):
    _, B, Hq, Hkv, Sq, Sk, D, causal, dtype = case
    return (_normal(gen, (B, Hq, Sq, D), dtype),
            _normal(gen, (B, Hkv, Sk, D), dtype),
            _normal(gen, (B, Hkv, Sk, D), dtype), causal)


def _rms_inputs(gen, case):
    _, rows, d, dtype = case
    return (_normal(gen, (rows, d), dtype),
            1 + _normal(gen, (d,), torch.float32, 0.05))


def _ssd_inputs(gen, case):
    _, b, s, h, p, n, g, chunk, dtype = case
    x = _normal(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_normal(gen, (b, s, h), torch.float32))
    A = -torch.exp(_normal(gen, (h,), torch.float32, 0.3))
    return (x, dt, A, _normal(gen, (b, s, g, n), dtype),
            _normal(gen, (b, s, g, n), dtype), chunk)


def _close(got, want, tol, atol=None):
    """Max abs error, and the largest |got - want| / (atol + tol * |want|)
    (atol defaults to tol): at most 1 where the two agree as numpy's
    assert_allclose with these atol and rtol = tol has it.  Computed in
    f32, or in f64 where either side is f64."""
    wide = torch.float64 if torch.float64 in (got.dtype, want.dtype) \
        else torch.float32
    got, want = got.to(wide), want.to(wide)
    require(got.shape == want.shape, f"shape {tuple(got.shape)} vs "
            f"{tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "output not finite")
    diff = (got - want).abs()
    atol = tol if atol is None else atol
    return float(diff.max()), float((diff / (atol + tol * want.abs())).max())


def _full_width_tol(name, dtype):
    """(rtol, atol) at full width: the stated tolerance, with the tighter
    atol of FULL_WIDTH_ATOL where there is one."""
    tol = OPS_TOL[name][dtype]
    return tol, FULL_WIDTH_ATOL.get((name, dtype), tol)


def phase_ops():
    """The op layer's main path on the card, with every launch count set to
    0 just before and read just after; then each output held against its
    kernel's plain version on the same inputs (launches not counted)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as sd
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "allow_tf32 must be False: f32 products stay f32")
    flash, rms, ssd, ssd_seq = _ops_cases()
    gen = torch.Generator(device="cuda").manual_seed(OPS_SEED)
    inputs = {"flash_attention": [_flash_inputs(gen, c) for c in flash],
              "rmsnorm": [_rms_inputs(gen, c) for c in rms],
              "ssd_scan": [_ssd_inputs(gen, c) for c in ssd]}
    seq_args = _ssd_inputs(gen, ssd_seq)
    # one backward: SmolLM-360M heads, 1 x 1024 tokens, f32
    gq, gk, gv, _ = _flash_inputs(gen, ("grad", 1, 15, 5, 1024, 1024, 64,
                                        True, torch.float32))
    gout = _normal(gen, gq.shape, torch.float32)
    torch.cuda.synchronize()

    fa.launches = rn.launches = sd.launches = 0
    t0 = time.perf_counter()
    outs = {"flash_attention": [ops.flash_attention(q, k, v, causal)
                                for q, k, v, causal in
                                inputs["flash_attention"]],
            "rmsnorm": [ops.rmsnorm(x, w) for x, w in inputs["rmsnorm"]],
            "ssd_scan": [ops.ssd_scan(*a) for a in inputs["ssd_scan"]]}
    seq_out = ops.ssd_scan(*seq_args)
    leaves = [t.detach().clone().requires_grad_() for t in (gq, gk, gv)]
    o = ops.flash_attention(*leaves, True)
    grads = torch.autograd.grad(o, leaves, gout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "rmsnorm": rn.launches,
                "ssd_scan": sd.launches}
    log(f"[ops] main path: {len(flash)} + 1 flash attention calls (one with "
        f"its backward), {len(rms)} rmsnorm, {len(ssd)} + 1 ssd_scan at full "
        f"widths in {wall:.2f} s wall; kernel launches {launches} (an "
        f"ssd_scan launch is one call of {sd.KERNELS_PER_CALL} kernels: "
        f"{', '.join(sd.PASSES)})")
    for name, n in launches.items():
        require(n > 0, f"the op layer's main path never launched {name}")

    errs = {}
    plain = {"flash_attention": lambda q, k, v, causal:
             fa.flash_attention_ref(q, k, v, causal=causal),
             "rmsnorm": rn.rmsnorm_ref, "ssd_scan": sd.ssd_scan_ref}
    cases = {"flash_attention": flash, "rmsnorm": rms, "ssd_scan": ssd}
    for name in cases:
        errs[name] = []
        for case, args, got in zip(cases[name], inputs[name], outs[name]):
            want = plain[name](*args)
            tol, atol = _full_width_tol(name, case[-1])
            pairs = zip(got, want) if name == "ssd_scan" else [(got, want)]
            err, worst = (max(v) for v in zip(*(_close(g, w, tol, atol)
                                                 for g, w in pairs)))
            log(f"[ops] {name} {case}: kernel vs plain on the card max abs "
                f"{err:.3e}, {worst:.3f} of the tolerance ({atol:.0e} abs + "
                f"{tol:.0e} rel)")
            require(worst <= 1, f"{name} {case}: kernel disagrees with its "
                    "plain version")
            errs[name].append(err)
    shares = _ssd_f64_shares(ssd, inputs["ssd_scan"], outs["ssd_scan"])
    y_seq, st_seq = ref.reference_ssd_sequential(*seq_args[:5])
    for part, got, want in (("y", seq_out[0], y_seq),
                            ("state", seq_out[1], st_seq)):
        err, worst = _close(got, want, SSD_SEQ_TOL)
        log(f"[ops] ssd_scan {ssd_seq} {part}: kernel vs the sequential "
            f"recurrence max abs {err:.3e}, {worst:.3f} of the tolerance "
            f"({SSD_SEQ_TOL:.0e} abs + rel)")
        require(worst <= 1, f"ssd_scan disagrees with the sequential "
                f"recurrence ({part})")
    leaves = [t.detach().clone().requires_grad_() for t in (gq, gk, gv)]
    want = torch.autograd.grad(fa.flash_attention_ref(*leaves, causal=True),
                               leaves, gout)
    for label, g, w in zip("qkv", grads, want):
        err, worst = _close(g, w, GRAD_TOL)
        log(f"[ops] ops.flash_attention backward d{label} (1 x 15/5 heads x "
            f"1024 x 64, causal, f32) vs autograd through the plain version: "
            f"max abs {err:.3e}, {worst:.3f} of the tolerance "
            f"({GRAD_TOL:.0e} abs + rel)")
        require(worst <= 1, f"d{label} disagrees with the plain path's "
                "gradient")
    _ops_views(gen)
    _ops_small_shapes(gen)
    return launches, errs, inputs, shares


def _ssd_f64_shares(cases, inputs, outs):
    """Where the SSD's f32 error comes from: the kernel's outputs and the
    f32 plain version's, each held against the plain version on f64 copies
    of the same inputs, as shares of the f32 tolerance (y and state, the
    larger)."""
    from repro_torch.kernels import ssd_scan as sd
    tol = OPS_TOL["ssd_scan"][torch.float32]
    shares = {}
    for case, args, got in zip(cases, inputs, outs):
        if case[-1] != torch.float32:
            continue
        wide = sd.ssd_scan_ref(*(a.double() if torch.is_tensor(a) else a
                                 for a in args))
        plain = sd.ssd_scan_ref(*args)
        row = {"kernel": max(_close(g, w, tol)[1] for g, w in zip(got, wide)),
               "plain": max(_close(g, w, tol)[1]
                            for g, w in zip(plain, wide)),
               "kernel_vs_plain": max(_close(g, w, tol)[1]
                                      for g, w in zip(got, plain))}
        shares[case[0]] = row
        log(f"[ops] ssd_scan {case}: held against the plain version on f64 "
            f"copies, share of the tolerance ({tol:.0e} abs + rel): kernel "
            f"{row['kernel']:.3f}, f32 plain version {row['plain']:.3f} "
            f"(kernel vs f32 plain {row['kernel_vs_plain']:.3f})")
        del wide, plain
    return shares


def _ops_views(gen):
    """Views on the card, each held against the plain version on the same
    view (launches made after the main path's counts were read): q, k, v
    made (B, S, H, D) and passed transposed (SmolLM-360M heads, 1 x 2048
    tokens, causal, both dtypes); ``x[1:]`` of an f32 (rows, 21) tensor and
    SmolLM-360M residual rows one element into a buffer, with ``w[1:]``; x
    transposed and B, C split out of one projection at Mamba2-2.7B
    width."""
    from repro_torch.configs.base import load_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as sd
    smol = load_config("smollm_360m")
    mamba = load_config("mamba2_2_7b")
    H, Hkv, D = smol.num_heads, smol.num_kv_heads, smol.head_dim
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = _normal(gen, (1, 2048, H, D), dtype).transpose(1, 2)
        kv = _normal(gen, (1, 2048, 2 * Hkv, D), dtype)
        k = kv[:, :, :Hkv].transpose(1, 2)
        v = kv[:, :, Hkv:].transpose(1, 2)
        require(not (q.is_contiguous() or k.is_contiguous()),
                "the flash view case must pass views")
        got = fa.flash_attention_fwd(q, k, v, causal=True)
        want = fa.flash_attention_ref(q, k, v, causal=True)
        worst[f"flash {dtype}"] = _close(
            got, want, *_full_width_tol("flash_attention", dtype))[1]
    for rows, d, dtype in ((4096, 21, torch.float32),
                           (4096, smol.d_model, torch.bfloat16),
                           (4096, smol.d_model, torch.float32)):
        # x[1:] of (rows + 1, 21); d = 960 rows are 16-byte multiples, so
        # those start one element into a flat buffer
        x = _normal(gen, (rows + 1, d), dtype)[1:] if d == 21 else \
            _normal(gen, (rows * d + 1,), dtype)[1:].view(rows, d)
        w = (1 + _normal(gen, (d + 1,), torch.float32, 0.05))[1:]
        require(x.data_ptr() % 16 != 0, "x must start off alignment")
        worst[f"rmsnorm offset x, w ({rows}, {d}) {dtype}"] = _close(
            rn.rmsnorm(x, w), rn.rmsnorm_ref(x, w),
            OPS_TOL["rmsnorm"][dtype])[1]
    h, p, n, g, chunk = (mamba.ssm_heads, mamba.ssm_headdim, mamba.ssm_state,
                         mamba.ssm_groups, mamba.ssm_chunk)
    x, dt, A, _, _, _ = _ssd_inputs(gen, ("", 1, 2 * chunk, h, p, n, g,
                                          chunk, torch.float32))
    x = x.transpose(1, 2).contiguous().transpose(1, 2)
    bc = _normal(gen, (1, 2 * chunk, g, 2 * n), torch.float32)
    B, C = bc[..., :n], bc[..., n:]
    for got, want in zip(sd.ssd_scan(x, dt, A, B, C, chunk),
                         sd.ssd_scan_ref(x, dt, A, B, C, chunk)):
        worst["ssd B, C split, x transposed"] = max(
            worst.get("ssd B, C split, x transposed", 0.0),
            _close(got, want, OPS_TOL["ssd_scan"][torch.float32])[1])
    log("[ops] views (transposed q, k, v; x[1:] and w[1:]; SSD x transposed "
        "and B, C split from one projection) vs the plain version on the "
        "same views, share of the tolerance: " + ", ".join(
            f"{k} {v:.3f}" for k, v in worst.items()))
    require(max(worst.values()) <= 1, "a kernel disagrees with its plain "
            "version on a view")


# the CPU tests' shapes (tests/test_torch_ops.py, tests/test_torch_ssd.py):
# head dims 8-32, causal with Sq < Sk and Sq > Sk, a 96-key tail tile; SSD
# groups, tiny widths, a 6-chunk scan and single chunks with h / g up to 4;
# rmsnorm widths that take one element a lane
SMALL_FLASH = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32),
               (1, 6, 2, 96, 96, 16), (2, 2, 1, 64, 128, 8),
               (1, 3, 1, 64, 64, 20), (1, 2, 1, 128, 64, 16)]
SMALL_SSD = [(1, 64, 2, 16, 16, 1, 16), (2, 128, 4, 32, 16, 2, 32),
             (1, 96, 2, 8, 8, 2, 16), (1, 32, 4, 16, 16, 1, 32),
             (2, 48, 6, 8, 16, 2, 48),
             (1, 60, 6, 12, 20, 3, 20)]     # (b, s, h, p, n, g, chunk)
SMALL_RMS = [(32, 64), (100, 128), (7, 16), (5, 21)]


def _ops_small_shapes(gen):
    """Each kernel against its plain version on the card at the CPU tests'
    shapes, both dtypes, both masks (launches made after the main path's
    counts were read)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as sd
    n, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SMALL_FLASH:
            for causal in (True, False):
                q, k, v, _ = _flash_inputs(gen, ("", *shape, causal, dtype))
                kw = {"causal": causal, "block_q": 32, "block_k": 32}
                worst = max(worst, _close(
                    fa.flash_attention_fwd(q, k, v, **kw),
                    fa.flash_attention_ref(q, k, v, **kw),
                    OPS_TOL["flash_attention"][dtype])[1])
                n += 1
        for b, s, h, p, nn, g, chunk in SMALL_SSD:
            args = _ssd_inputs(gen, ("", b, s, h, p, nn, g, chunk, dtype))
            for got, want in zip(sd.ssd_scan(*args), sd.ssd_scan_ref(*args)):
                worst = max(worst, _close(got, want,
                                          OPS_TOL["ssd_scan"][dtype])[1])
            n += 1
        for rows, d in SMALL_RMS:
            x, w = _rms_inputs(gen, ("", rows, d, dtype))
            # w in f32 and in bf16: the kernel reads either
            for w in (w, w.to(torch.bfloat16)):
                worst = max(worst, _close(rn.rmsnorm(x, w),
                                          rn.rmsnorm_ref(x, w),
                                          OPS_TOL["rmsnorm"][dtype])[1])
                n += 1
    # x and B/C in different dtypes (held to the bf16 tolerance)
    other = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float32}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, p, nn, g, chunk in SMALL_SSD:
            x, *rest = _ssd_inputs(gen, ("", b, s, h, p, nn, g, chunk, dtype))
            args = (x.to(other[dtype]), *rest)
            for got, want in zip(sd.ssd_scan(*args), sd.ssd_scan_ref(*args)):
                worst = max(worst, _close(
                    got, want, OPS_TOL["ssd_scan"][torch.bfloat16])[1])
            n += 1
    log(f"[ops] {n} small-shape cases (the CPU tests' shapes, f32 and bf16, "
        "rmsnorm's w in both, SSD's x and B/C in either): every kernel within "
        f"{worst:.3f} of its tolerance of its plain version")
    require(worst <= 1, "a kernel disagrees with its plain version at the "
            "CPU tests' shapes")


def _flash_pairs(Sq, Sk, causal):
    """Query/key pairs the function needs: with top-left causal alignment,
    query i sees min(i + 1, Sk) keys."""
    if not causal:
        return Sq * Sk
    full = max(0, Sq - Sk)           # rows that see every key
    part = min(Sq, Sk)               # rows i < Sk see i + 1 keys
    return part * (part + 1) // 2 + full * Sk


def _peak(dtype):
    """The card's peak for products of inputs of ``dtype``: the bf16
    tensor-core rate for bf16, the TF32 rate for f32."""
    return H100_SXM["peak_bf16_flops" if dtype == torch.bfloat16
                    else "peak_tf32_flops"]


def _bound_ops(name, args):
    """Least time (ms) of one call on these inputs: each input read once and
    each output written once over HBM, or the products' FLOP at the peak for
    the input type (flash attention: 4 * D a query/key pair the mask keeps;
    SSD, per chunk: the scores C B^T once a group, 2 * N a lower-triangle
    (i, j) pair, and a head's product of the masked scores with xbar, 2 * P
    a pair, and 2 * Q * P * N each for its state read-out and update);
    rmsnorm: 4 FLOP an element at the FP32 rate.  The larger of the two."""
    if name == "flash_attention":
        q, k, v, causal = args
        B, Hq, Sq, D = q.shape
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        flop = 4 * D * B * Hq * _flash_pairs(Sq, k.shape[2], causal)
        return _bound(nbytes, flop, _peak(q.dtype))
    if name == "rmsnorm":
        x, w = args
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        return _bound(nbytes, 4 * x.numel(), H100_SXM["peak_fp32_flops"])
    x, dt, A, B, C, chunk = args
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    Q = min(chunk, s)
    nbytes = (2 * x.numel() * x.element_size()
              + 2 * B.numel() * B.element_size()
              + 4 * (dt.numel() + A.numel() + b * h * p * n))
    pairs = Q * (Q + 1) // 2
    per_chunk = g * 2 * n * pairs + h * (2 * p * pairs + 4 * Q * p * n)
    return _bound(nbytes, b * (s // Q) * per_chunk, _peak(x.dtype))


def _library_op(name):
    """One PyTorch call that computes the kernel's function on the same
    inputs (timed here as a yardstick; the port never calls it), and what
    it is: ``F.scaled_dot_product_attention(enable_gqa=True)``,
    ``F.rms_norm``; none for the SSD scan."""
    F = torch.nn.functional
    if name == "flash_attention":
        return (lambda q, k, v, causal: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True),
            "F.scaled_dot_product_attention(enable_gqa=True)")
    if name == "rmsnorm":
        return (lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-5),
                "F.rms_norm")
    return None, None


def _median(values):
    return sorted(values)[len(values) // 2]


OPS_ROUNDS = 3   # interleaved device-time samples of kernel and library

# The cases whose library call may miss the kernel's own limit, logged and
# reported with no yardstick; any other case fails the run there.  SDPA at
# Phi-3-mini's D = 96 rounds P to bf16 (1.32 of atol 1e-3 + rtol 2e-2 on
# an H100), where the kernel splits P into bf16 big + small.
LIBRARY_OFF_LIMIT = {("flash_attention", "phi3_mini_3_8b", torch.bfloat16)}


def _ssd_stage_ms(args, reps):
    """Each of ssd_scan's kernels launched alone on the call's inputs and
    passes.  First each is held against its plain pass on the same inputs
    (the f32 scratch at the f32 tolerance, y at its dtype's; the scores
    below the diagonal only) and fails past it; then it is timed: device ms
    a launch back to back, median of OPS_ROUNDS (the state pass on a copy,
    which it overwrites).  Returns (ms by pass, worst share by output)."""
    from repro_torch.kernels import ssd_scan as sd
    x, dt, A, B, C, chunk = args
    f32 = OPS_TOL["ssd_scan"][torch.float32]
    shares = {}

    def hold(what, got, want, tol=f32):
        shares[what] = _close(got, want, tol)[1]

    cum, local = sd.ssd_chunk_state(x, dt, A, B, chunk)
    for what, got, want in zip(("cum", "local"), (cum, local),
                               sd.ssd_chunk_state_ref(x, dt, A, B, chunk)):
        hold(what, got, want)
    want_states, want_final = sd.ssd_state_pass_ref(local, cum, chunk)
    states, final = sd.ssd_state_pass(local, cum, chunk)
    hold("states", states, want_states)
    hold("final", final, want_final)
    cb = sd.ssd_chunk_cb(B, C, chunk)
    hold("cb", torch.tril(cb), sd.ssd_chunk_cb_ref(B, C, chunk))
    hold("y", sd.ssd_chunk_scan(x, dt, C, cum, cb, states, chunk),
         sd.ssd_chunk_scan_ref(x, dt, C, cum, torch.tril(cb), states, chunk),
         OPS_TOL["ssd_scan"][x.dtype])
    require(max(shares.values()) <= 1, "an SSD pass disagrees with its plain "
            "pass: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    calls = {"chunk_state": (sd.ssd_chunk_state, (x, dt, A, B, chunk)),
             "state_pass": (sd.ssd_state_pass, (states.clone(), cum, chunk)),
             "chunk_cb": (sd.ssd_chunk_cb, (B, C, chunk)),
             "chunk_scan": (sd.ssd_chunk_scan,
                            (x, dt, C, cum, cb, states, chunk))}
    require(list(calls) == list(sd.PASSES), "the SSD passes are timed in "
            "the order ssd_scan runs them")
    return {k: _median([_device_ms(fn, a, reps, 0.0)
                        for _ in range(OPS_ROUNDS)])
            for k, (fn, a) in calls.items()}, shares


def phase_ops_timing(inputs):
    """Each case of the op layer's main path: the kernel's event time a
    call, its device time a launch back to back, the plain version's time,
    the library call's time and the bound.  The kernel's and the library
    call's device times are the medians of OPS_ROUNDS samples taken in
    turns (kernel, library, library, kernel, ...)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as sd
    flash, rms, ssd, _ = _ops_cases()
    fns = {"flash_attention": (lambda q, k, v, causal: fa.flash_attention_fwd(
               q, k, v, causal=causal),
           lambda q, k, v, causal: fa.flash_attention_ref(
               q, k, v, causal=causal)),
           "rmsnorm": (rn.rmsnorm, rn.rmsnorm_ref),
           "ssd_scan": (sd.ssd_scan, sd.ssd_scan_ref)}
    cases = {"flash_attention": flash, "rmsnorm": rms, "ssd_scan": ssd}
    reps = {"flash_attention": 5, "rmsnorm": 100, "ssd_scan": 5}
    out = {}
    for name, (fn, ref) in fns.items():
        lib, lib_what = _library_op(name)
        out[name] = []
        for case, args in zip(cases[name], inputs[name]):
            bound_ms, bound_by = _bound_ops(name, args)
            n = reps[name]
            ms = _time_ms(fn, args, reps=n)
            plain_ms = _time_ms(ref, args, reps=1)
            samples = {fn: [], lib: []}
            for r in range(OPS_ROUNDS):
                for f in ((fn, lib) if r % 2 == 0 else (lib, fn)):
                    if f is not None:
                        samples[f].append(_device_ms(f, args, n, bound_ms))
            device_ms = _median(samples[fn])
            library_ms = lib_text = None
            if lib is not None:
                # the library call is a yardstick only where it computes the
                # kernel's function within the kernel's own limit
                lib_err, lib_worst = _close(lib(*args), ref(*args),
                                            *_full_width_tol(name, case[-1]))
                lib_ms = _time_ms(lib, args, reps=n)
                lib_device_ms = _median(samples[lib])
                require(lib_worst <= 1 or (name, case[0], case[-1])
                        in LIBRARY_OFF_LIMIT, f"{name} {case}: the library "
                        f"call is {lib_worst:.3f} of the kernel's limit")
                if lib_worst <= 1:
                    library_ms = lib_ms
                    lib_text = (f", library {lib_ms:.4f} ms (device "
                                f"{lib_device_ms:.4f} ms a launch; "
                                f"{lib_what})")
                else:
                    lib_text = (f", library {lib_ms:.4f} ms ({lib_what}) "
                                f"not a yardstick: {lib_worst:.3f} of the "
                                f"limit from the plain version (max abs "
                                f"{lib_err:.3e})")
            row = {"case": [str(c) for c in case], "ms": ms,
                   "device_ms": device_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library": lib_what,
                   "library_device_ms": None if library_ms is None
                   else lib_device_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "device_ms_samples": samples[fn]}
            if lib is not None:
                row["library_device_ms_samples"] = samples[lib]
            if lib_text and library_ms is None:
                row["library_off_limit"] = {"ms": lib_ms, "worst": lib_worst,
                                            "max_abs": lib_err}
            if name == "ssd_scan":
                row["stage_device_ms"], row["stage_worst"] = _ssd_stage_ms(
                    args, n)
                log(f"[ops-timing] ssd_scan {case} passes alone vs their "
                    f"plain passes, share of the limit: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in row["stage_worst"].items()))
                log(f"[ops-timing] ssd_scan {case} kernels alone, device ms "
                    f"a launch (median of {OPS_ROUNDS} x {n}): " + ", ".join(
                        f"{k} {v:.4f}" for k, v in
                        row["stage_device_ms"].items())
                    + f"; sum {sum(row['stage_device_ms'].values()):.4f} "
                    f"(whole call {device_ms:.4f})")
            out[name].append(row)
            lib_text = lib_text or ""
            log(f"[ops-timing] {name} {case}: kernel {ms:.4f} ms a call "
                f"(device {device_ms:.4f} ms a launch, median of "
                f"{OPS_ROUNDS} x {n} back to back), plain {plain_ms:.3f} "
                f"ms{lib_text}, bound {bound_ms:.5f} ms ({bound_by}), "
                f"kernel/bound {device_ms / bound_ms:.1f}")
    return out


def main():
    from repro_torch.kernels import ssd_scan as sd
    smi = phase_device()
    phase_build()
    card_tests = phase_card_tests()
    phase_kernel_checks()
    machines, wall, launches, models = phase_main_path()
    timing = phase_main_chunks(machines, launches)
    phase_breakdown()
    serve_launches, served_waves, wide_args, serve = phase_serve(models)
    serve_kernel = phase_serve_kernel(served_waves, wide_args)
    errs = phase_blockers()
    blocker_launches, profiles = phase_hardware()
    blocker_times = phase_blocker_timing()
    ops_launches, ops_errs, ops_inputs, ssd_shares = phase_ops()
    ops_times = phase_ops_timing(ops_inputs)
    big = timing["largest"]
    report = {"kernels": [{
        "name": "wave_dispatch", "route": "cuda",
        "source": "src/repro_torch/csrc/wave_dispatch.cu",
        "replaces": "src/repro/core/batch_sim.py:1714",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "device_ms": big["device_ms"],
        "shape_SERMP": big["shape"],
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
    report["card_tests_passed"] = card_tests
    replaces = {"flash_attention": "flash_attention.py:26",
                "rmsnorm": "rmsnorm.py:16", "ssd_scan": "ssd_scan.py:25"}
    for name, rows in ops_times.items():
        head = rows[0]
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{replaces[name]}",
            "launches": ops_launches[name],
            "max_abs_err": max(ops_errs[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "device_ms": head["device_ms"], "case": head["case"],
            "other_cases": rows[1:]})
        if name == "ssd_scan":
            report["kernels"][-1].update(
                stage_device_ms=head["stage_device_ms"],
                stage_worst=head["stage_worst"],
                kernels_per_call=sd.KERNELS_PER_CALL,
                f64_shares=ssd_shares)
    report["kernels"].append({
        "name": "port_bound", "route": "cuda",
        "source": "src/repro_torch/csrc/port_bound.cu",
        "replaces": "src/repro/service/batch_predictor.py:302",
        "launches": serve_launches, "library_ms": None, **serve_kernel,
        "served_waves": len(served_waves), **serve})
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
