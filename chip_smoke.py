"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's six kernel libraries from ``src/repro_torch/csrc`` with
nvcc, in parallel, runs the jax-free card tests
(``python -m pytest -m cuda tests/test_torch_card_*.py``) against them, and
drives the port's paths on the card:

* **characterize -> export.**  The wave-dispatch kernel is held bit for
  bit against its plain PyTorch version on the card; then a ``Campaign``
  over the full ``TEST_ISA`` on all three simulated uarches runs with the
  ``cuda`` backend, exported with ``model_io``, and its XML and JSON must be
  byte-identical to the same campaign on the ``torch`` backend on the CPU.
* **the lane mesh.**  ``SimMachine(devices=1)`` on ``sim_skl`` gives the
  campaign's XML; the same campaign with every machine on two logical
  devices of the card (``("cuda:0", "cuda:0")``: each chunk of at least
  ``2 x min_lanes`` lanes split into two lane blocks, one launch each;
  also on ``cuda:0`` and ``cuda:1`` when the host has a second card)
  gives its XML and JSON byte for byte, the widest chunk's blocks equal
  to the plain version, its wall, launches and summed kernel time beside
  the one-device campaign's; in the corpus phase the first ``sim_skl``
  shard evaluated at that placement equals the card's rows bit for bit.
* **predict -> serve -> query.**  The campaign's three models are served
  by ``start_server(predict_backend="cuda")`` to a JSON and a binary
  client (the README's block and 1,024 random blocks a uarch); the
  payloads must be byte-identical across the wires and to the numpy
  backend on the CPU, with device waves served and none routed back.  A
  10,000-block wave runs in process bit-identical to numpy, and
  ``simulate_batch`` on the card equals the CPU machine.  The port-bound
  kernel is then held against its plain version on every wave it served
  and on random, tie, all-zero and near-guard inputs, and timed beside its
  plain version and its bound: at the widest wave, and at each served
  (C, S) for 32 to 9,936 rows.
* **the entry scripts.**  ``examples/quickstart_torch.py`` and a copy of
  ``examples/export_models_torch.py`` run on the card in child processes
  that cannot import jax or ``repro``: the quickstart prints the CPU
  backend's lines, the export writes the campaign's XML, and a warm re-run
  replays every experiment from its cache with no launch.
* **corpus evaluation.**  The README corpus (seed 0, 10,000 blocks a
  uarch, all three uarches) is generated and evaluated on the card,
  traced: ground truth through the wave-dispatch kernel, predictions
  through the port-bound kernel, walls per uarch and stage.  A resumed
  run launches nothing; the first shard of each uarch equals the CPU
  ``torch`` backend bit for bit; ``sim_skl`` served through
  ``client_predict_fn`` gives the in-process artifact on both wires; the
  widest launch of each kernel is held against its plain version.
* **trace export and the wave report.**  The corpus run's trace is
  written by ``repro_torch.obs.export`` as Chrome trace-event JSON and as
  JSONL, read back from both (the same events) and reported by
  ``repro_torch.analysis.wave_report`` (the same report): one ``kernel``
  span a traced wave-dispatch launch, ``device:cuda:0`` busy for the
  executors' ``kernel_ns``, a named bottleneck.
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
* **model serving** (``repro_torch.models``, ``train/serve.py``).
  SmolLM-360M uncut (f32 weights, bf16 compute): 8 x 128 tokens prefilled,
  64 greedy decode steps, ``generate`` giving the same ids; Qwen2-VL-2B,
  Phi-3.5-MoE, Mamba2-2.7B and Zamba2-2.7B at full width with their depth
  cut: 2 x 256 positions and 8 steps.  Logits finite; in f32 compute a
  decode step after a prefill equals a prefill one token longer, and the
  card's logits equal the CPU's on the same weights at 2 layers (one
  super-block for the hybrid).  Prefill tokens/s, decode ms a step and
  peak memory beside the card's name and power limit.  The models are
  plain PyTorch, as the reference's are plain jnp: no kernel of the port
  is on this path.
* **training** (``launch/train.py``, ``train/train_loop.py``,
  ``optim/adamw.py``, ``checkpoint/checkpoint.py``, ``data/pipeline.py``).
  SmolLM-360M uncut (f32 weights and AdamW state, bf16 compute, full
  remat) through ``launch.train.train``: 30 steps of 8 x 128 tokens with
  a checkpoint every 10, the loss falling and every gradient norm finite;
  a run resumed from the step-10 checkpoint equals the uninterrupted
  run's step-20 checkpoint; ms a step, tokens/s, peak memory beside
  weights and AdamW state, and the card's busy share of 2 profiled
  steps.  Qwen2-VL-2B, Phi-3.5-MoE, Mamba2-2.7B, Zamba2-2.7B and
  Whisper-medium train 2 steps each at full width, depth cut, and one
  f32 backward of every family equals the CPU's.  No kernel of the port
  is on this path either.
* **the mesh** (``launch/mesh.py``, ``models/sharding.py``,
  ``train/pipeline.py``).  One NCCL rank (``make_host_mesh(1, 1)``: one
  H100, so N > 1 runs only in the CPU tests, over gloo): SmolLM-360M uncut
  trained sharded through ``launch.train.train(mesh=)`` for 5 steps, its
  losses against the training phase's first 5, a checkpoint at step 3 and
  a resumed run bit-identical to the uninterrupted one, the sharded
  step's ms and kernels beside the unsharded step's; a sequence-sharded
  decode step, the vocab-parallel CE at SmolLM's vocabulary, ``psum_int8``,
  a one-stage pipeline and Phi-3.5-MoE's expert-parallel loss and
  gradients (2 layers, full width) against their local versions.  The
  regions are PyTorch plus NCCL collectives: no kernel of the port.
* **the dry run** (``launch/dryrun.py``, ``analysis/{hlo_stats,roofline,
  report}.py``).  A child process that cannot import jax or ``repro``,
  started at the beginning and tracing on the host beside the other
  phases, dry-runs production cells on fake CUDA tensors over ``fake``
  process groups of 256 and 512 ranks (SmolLM-360M's train, prefill and
  decode and Phi-3.5-MoE's decode on (16, 16), SmolLM's decode on
  (2, 16, 16)): bytes a device, the 80 GB fit, collectives, FLOPs, the
  three roofline terms.  SmolLM-360M's 8 x 128 train step, dry-run on a
  1 x 1 mesh, then runs for real on one NCCL rank: FLOPs and argument
  bytes equal, the peak within ``DRYRUN_PEAK_RATIO`` of
  ``max_memory_allocated``, the step no faster than its compute bound.

Every phase prints a line; any failure exits non-zero and prints no
result.  The last three lines are the card's name and power limit, the
kernel report and the device line, both JSON.

Imports nothing of jax and nothing of the reference package ``repro``.
"""
import contextlib
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
    """Per kernel function of the library: how many HMMA, HGMMA, FFMA,
    MUFU.RSQ and LDGSTS (cp.async) instructions its SASS holds (None
    without cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0, "MUFU.RSQ": 0,
                          "LDGSTS": 0}
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
    # the port bound copies its u tiles with cp.async (every instance whose
    # last template argument, kTile, is true) and uses no tensor cores
    fns = {f: c for f, c in _sass_counts(pb.LIBRARY.path).items()
           if "port_bound_kernel" in f}
    require(len(fns) > 0, "port_bound_kernel not found in the SASS")
    tiled = [f for f in fns if f.endswith("Lb1EEv4Args")]
    require(len(tiled) > 0, "no port_bound_kernel instance copies tiles")
    for f, c in fns.items():
        require(c["HMMA"] + c["HGMMA"] == 0, f"{f}: tensor-core products")
    for f in tiled:
        require(fns[f]["LDGSTS"] > 0, f"{f}: no cp.async in its SASS")
    log(f"[build] SASS port_bound_kernel: {len(fns)} instantiations, "
        f"{len(tiled)} copying tiles with cp.async (LDGSTS "
        f"{min(fns[f]['LDGSTS'] for f in tiled)}-"
        f"{max(fns[f]['LDGSTS'] for f in tiled)}), no HMMA or HGMMA")


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
    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.kernels import wave_dispatch as wd

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
        xml, js = _export(res.models[name])
        cxml, cjs = _export(cpu.models[name])
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
    device_us = {k: us for k, (us, _) in _device_us(prof).items()}
    busy = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    log(f"[breakdown] device busy {busy:.4f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.2f}%); by kernel: " + "; ".join(
            f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top)
        if busy else "[breakdown] the profiler recorded no device time: "
        "device busy share not measured")


# ----------------------------------------------------------- lane mesh
LANES_PLACEMENT = ("cuda:0", "cuda:0")   # two lane blocks on one card


def _export(model):
    """A campaign model's XML and JSON, ``run_seconds`` 0."""
    from repro_torch.core import model_io
    from repro_torch.core.isa import TEST_ISA
    model.run_seconds = 0.0
    return model_io.to_xml(model, TEST_ISA), model_io.to_json(model)


@contextlib.contextmanager
def _sim_devices(spec):
    """``REPRO_SIM_DEVICES`` set to ``spec`` inside the block: the
    placement ``Campaign.run`` partitions among its machines."""
    from repro_torch.core.device_mesh import ENV_DEVICES
    old = os.environ.get(ENV_DEVICES)
    os.environ[ENV_DEVICES] = spec
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(ENV_DEVICES, None)
        else:
            os.environ[ENV_DEVICES] = old


@contextlib.contextmanager
def _chunk_log(chunks):
    """Every chunk the wave executors dispatch in this block appends its
    real lanes, its lane blocks and their launch arguments (the
    executor's ``record`` entries, one a block) to ``chunks``."""
    from repro_torch.core import batch_sim as bs
    dispatch = bs._DeviceExec.dispatch

    def logged(self, pk, n_use, record=None):
        record = [] if record is None else record
        k0 = len(record)
        out = dispatch(self, pk, n_use, record)
        chunks.append({"exec": self, "lanes": pk.E, "blocks": n_use,
                       "args": record[k0:]})
        return out

    bs._DeviceExec.dispatch = logged
    try:
        yield
    finally:
        bs._DeviceExec.dispatch = dispatch


def _lanes_campaign(placement, main_models):
    """The full ``TEST_ISA`` campaign on the three uarches, every machine
    on ``placement`` (one device: the one-device path, warm); its XML and
    JSON must equal ``[main]``'s, and every chunk of at least ``mesh width
    x min_lanes`` lanes must run as that many blocks, one launch each."""
    from repro_torch.core.batch_sim import DEFAULT_MIN_LANES
    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.kernels import wave_dispatch as wd

    machines = [SimMachine(ua, TEST_ISA, backend="cuda", devices=placement)
                for ua in SIM_UARCHES.values()]
    for m in machines:
        m.launched_args = []
    chunks = []
    n = len(placement)
    with _sim_devices(",".join(placement * len(machines))), \
            _chunk_log(chunks):
        torch.cuda.synchronize()
        wd.launches = 0
        t0 = time.perf_counter()
        res = Campaign().run(machines, TEST_ISA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wd.launches
    require(res.quarantined == 0, f"quarantined: {res.quarantine}")
    require(launches == sum(len(m.launched_args) for m in machines)
            == sum(c["blocks"] for c in chunks),
            f"{launches} launches vs the blocks kept")
    for c in chunks:
        want = max(1, min(n, c["lanes"] // DEFAULT_MIN_LANES))
        require(c["blocks"] == want == len(c["args"]),
                f"a {c['lanes']}-lane chunk ran as {c['blocks']} blocks "
                f"({len(c['args'])} launches), not {want}")
    stats = {}
    for m in machines:
        xml, js = _export(res.models[m.name])
        mxml, mjs = _export(main_models[m.name])
        require(xml == mxml and js == mjs,
                f"{m.name}: XML/JSON at {placement} differ from [main]'s")
        st = m.device_stats()
        own = [c for c in chunks if c["exec"] is m._batch._device]
        lanes = sum(c["lanes"] for c in own)
        require(st["mesh"] is (n > 1) and st["devices"] == list(placement),
                f"{m.name}: placement {st['devices']} mesh {st['mesh']}")
        require(sum(c["lanes"] for c in st["per_device"].values()) == lanes
                and st["kernel_calls"] == len(own),
                f"{m.name}: per-device lanes {st['per_device']} vs the "
                f"{lanes} lanes of {len(own)} chunks")
        stats[m.name] = {"chunks": len(own), "lanes": lanes,
                         "per_device": st["per_device"]}
    wide = max(chunks, key=lambda c: (c["lanes"], c["args"][0][0].shape[0]))
    err = kernel_ms = 0
    for args in wide["args"]:
        with torch.cuda.device(args[0].device):
            err = max(err, kernel_vs_plain(args))
    for c in chunks:
        for args in c["args"]:
            with torch.cuda.device(args[0].device):
                kernel_ms += _time_ms(wd.wave_dispatch, args, reps=1)
    split = sum(c["blocks"] > 1 for c in chunks)
    return {"placement": list(placement), "wall_s": wall,
            "launches": launches, "chunks": len(chunks),
            "split_chunks": split, "campaign_kernel_ms": kernel_ms,
            "widest_chunk": {"lanes": wide["lanes"],
                             "blocks_SER": [list(a[5].shape)
                                            for a in wide["args"]],
                             "max_abs_err": err},
            "machines": stats}


def phase_lanes(main_models, main_wall, main_launches, timing, smi):
    """The lane mesh on the card.  N = 1: ``SimMachine(devices=1)`` on
    ``sim_skl`` gives ``[main]``'s XML.  N = 2: the full campaign with
    every machine on two logical devices of ``cuda:0`` (and, with a second
    card, on ``cuda:0`` and ``cuda:1``) gives ``[main]``'s XML and JSON,
    each chunk of at least ``2 x min_lanes`` lanes split into two lane
    blocks; the widest chunk's blocks against the plain version; walls,
    launches and summed kernel ms beside the same campaign's on one
    device, run just before it (warm, as it is: ``[main]``'s is the
    process's first campaign)."""
    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_SKL

    cards = torch.cuda.device_count()
    one = SimMachine(SIM_SKL, TEST_ISA, backend="cuda", devices=1)
    with _sim_devices("cuda:0"):
        res = Campaign().run([one], TEST_ISA)
    st = one.device_stats()
    require(st["mesh"] is False and st["devices"] == ["cuda:0"],
            f"N = 1: placement {st['devices']} mesh {st['mesh']}")
    require(_export(res.models["sim_skl"])[0]
            == _export(main_models["sim_skl"])[0],
            "N = 1: sim_skl XML differs from [main]'s")
    log(f"[lanes] N = 1: SimMachine(devices=1) on sim_skl, XML equal to "
        f"[main]'s ({st['kernel_calls']} kernel calls on cuda:0)")
    warm = _lanes_campaign(("cuda:0",), main_models)
    require(warm["launches"] == main_launches,
            f"N = 1 warm: {warm['launches']} launches, [main] "
            f"{main_launches}")
    log(f"[lanes] N = 1 on ('cuda:0',), warm: campaign XML and JSON "
        f"byte-identical to [main]; {warm['chunks']} chunks, "
        f"{warm['launches']} launches, wall {warm['wall_s']:.2f} s, kernel "
        f"device time summed over the launches "
        f"{warm['campaign_kernel_ms']:.3f} ms ({smi})")
    runs = [_lanes_campaign(LANES_PLACEMENT, main_models)]
    if cards > 1:
        runs.append(_lanes_campaign(("cuda:0", "cuda:1"), main_models))
    for r in runs:
        w = r["widest_chunk"]
        log(f"[lanes] N = 2 on {tuple(r['placement'])}: campaign XML and "
            f"JSON byte-identical to [main]; {r['chunks']} chunks, "
            f"{r['split_chunks']} split in two lane blocks, "
            f"{r['launches']} launches (N = 1: {warm['launches']}, [main]: "
            f"{main_launches}); wall {r['wall_s']:.2f} s (N = 1 warm: "
            f"{warm['wall_s']:.2f} s, [main] cold: {main_wall:.2f} s); "
            f"kernel device time summed over the launches "
            f"{r['campaign_kernel_ms']:.3f} ms (N = 1: "
            f"{warm['campaign_kernel_ms']:.3f} ms, [main]: "
            f"{timing['campaign_kernel_ms']:.3f} ms); widest "
            f"chunk {w['lanes']} lanes as blocks (S, E, R) = "
            f"{w['blocks_SER']}, each equal to the plain version ({smi})")
    log(f"[lanes] cards on this host: {cards}; "
        + ("N = 2 also ran on cuda:0 and cuda:1" if cards > 1 else
           "N > 1 ran on logical devices of cuda:0 (two lane blocks a "
           "chunk on one card); distinct cards untested"))
    return {"cards": cards, "n1_kernel_calls": st["kernel_calls"],
            "n1": warm, "n2": runs}


# ------------------------------------------------------ predict -> serve
README_BLOCK = "IMUL_R64_R64 op1=R0 op2=R1\nADD_R64_R64 op1=R0 op2=R2"
SERVE_SEED = 1234
SERVE_BLOCKS = 1024       # one predict_batch a uarch and wire
WIDE_BLOCKS = 10_000      # one uarch's share of the corpus (README)
SIM_BLOCKS = 256          # simulate-backed blocks a uarch
LOAD_SECONDS = 2.0        # closed-loop load a wire (cached answers)
CORPUS_WAVE = 2048        # the README's --wave-width


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


# rows a launch at which the served shapes are timed: a small served wave,
# the serve phase's waves, the corpus's wave width and the widest wave
SERVED_ROWS = (32, 256, 1024, 2048, 9936)


def _bcs(args):
    """``[B, C, S]`` of a port-bound launch's ``(u, mask, size)``."""
    return [args[0].shape[0], *args[1].shape]


def _port_bound_bytes(B, C, S):
    """Bytes one launch must move: u, mask and size read once, the (2, B)
    result written once."""
    return 4 * (B * C + C * S + S + 2 * B)


def _served_shapes(launched):
    """For each served (C, S), the widest predictor's tables and its
    served rows: rows of every wave launched with those tables."""
    groups = {}
    for u, mask, size in launched:
        g = groups.setdefault(id(mask), [mask, size, []])
        g[2].append(u)
    shapes = {}
    for mask, size, us in groups.values():
        key = tuple(mask.shape)
        rows = torch.cat(us)
        if key not in shapes or len(rows) > len(shapes[key][2]):
            shapes[key] = (mask, size, rows)
    return shapes


def _served_shape_times(launched):
    """The kernel at each served (C, S) and every ``SERVED_ROWS`` count,
    on served rows drawn with replacement (seeded): equal to its plain
    version, its device ms a launch (200 back to back) and its bound."""
    from repro_torch.kernels import port_bound as pb
    rng = np.random.default_rng(SERVE_SEED)
    out = []
    for (C, S), (mask, size, rows) in sorted(_served_shapes(launched)
                                             .items()):
        for B in SERVED_ROWS:
            pick = torch.from_numpy(rng.integers(0, len(rows), B)).to(
                rows.device)
            args = (rows[pick].contiguous(), mask, size)
            err = port_bound_vs_plain(args)
            nbytes = _port_bound_bytes(B, C, S)
            bound_ms, bound_by = _bound(nbytes, _port_bound_ops(*args),
                                        H100_SXM["peak_fp32_flops"])
            ms = _device_ms(pb.port_bound, args, 200, bound_ms)
            out.append({"shape_BCS": [B, C, S], "device_ms": ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": nbytes, "max_abs_err": err})
            log(f"[serve-kernel] served shape B={B} C={C} S={S}: device "
                f"{ms:.5f} ms a launch, bound {bound_ms:.6f} ms "
                f"({bound_by}), equal to the plain version")
    return out


def _port_bound_ops(u, mask, size):
    """What these inputs need: an add per (row, combination with uops,
    candidate holding it), and two products and a compare per (row,
    candidate)."""
    adds = int(((u != 0).sum(0, dtype=torch.int64)
                * mask.sum(1, dtype=torch.int64)).sum())
    return adds + 3 * u.shape[0] * mask.shape[1]


def phase_serve_kernel(launched, wide_args):
    """The port-bound kernel against its plain version on the card: every
    wave the serve path launched, then random, tie, all-zero and
    near-guard inputs; then the widest wave's launch timed beside its
    plain version and its bound; then the kernel at every served
    shape."""
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
    nbytes = _port_bound_bytes(B, C, S)
    ops = _port_bound_ops(*wide_args)
    bound_ms, bound_by = _bound(nbytes, ops, H100_SXM["peak_fp32_flops"])
    ms = _time_ms(pb.port_bound, wide_args, reps=200)
    device_ms = _device_ms(pb.port_bound, wide_args, 200, bound_ms)
    plain_ms = _time_ms(pb.port_bound_ref, wide_args, reps=3)
    log(f"[serve-kernel] widest wave B={B} C={C} S={S}: kernel {ms:.4f} ms "
        f"a call (device {device_ms:.4f} ms a launch, 200 back to back), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} operations)")
    served = _served_shape_times(launched)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches_BCS": [_bcs(args) for args in launched],
            "max_abs_err": max([err] + [r["max_abs_err"] for r in served]),
            "shape_BCS": [B, C, S], "served_shapes": served}

# ------------------------------------------- entry scripts and the corpus
# a child process that cannot import jax or the reference package, then
# runs the script as __main__ and reports the kernels' launches on stderr
POISONED = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'repro'):\n"
    "    sys.modules[name] = None\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "finally:\n"
    "    wd = sys.modules.get('repro_torch.kernels.wave_dispatch')\n"
    "    print(f'wave_dispatch launches: {wd.launches if wd else 0}',\n"
    "          file=sys.stderr)\n")


def _script(path, env, *, cwd=None):
    """Start ``path`` in a poisoned child; :func:`_finish` waits.  Every
    child has the same string-hash seed: a model's JSON holds LP results
    whose last bit follows the order of a frozenset of port names (the
    reference's ``core/lp.py:_scipy_lp``), so JSON compares only between
    processes of one seed."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("REPRO_")}
    base.update(PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0", **env)
    return subprocess.Popen([sys.executable, "-c", POISONED, str(path)],
                            cwd=cwd or ROOT, env=base, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc, what, timeout=600):
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        log(out[-4000:])
        log(err[-4000:])
    require(proc.returncode == 0, f"{what} exited {proc.returncode}")
    m = re.search(r"wave_dispatch launches: (\d+)", err)
    require(m is not None, f"{what}: no launch count")
    return out, int(m.group(1)), time.perf_counter() - t0


def _hit_rates(stdout):
    return [line.rsplit("cache hit rate ", 1)[1].rstrip(")")
            for line in stdout.splitlines() if "cache hit rate" in line]


def phase_scripts(models):
    """The README's two entry scripts of the port, each in a child process
    where ``import jax`` and ``import repro`` fail, on the card's defaults
    (no ``REPRO_*`` variable): ``examples/quickstart_torch.py`` must print
    what the same script prints on the CPU ``torch`` backend, line for
    line; a copy of ``examples/export_models_torch.py`` (it writes beside
    itself) must export XML byte-identical to ``[main]``'s models and JSON
    (``run_seconds`` set to 0) equal to a copy run on the CPU ``torch``
    backend, and a warm re-run must replay every experiment from its cache
    (100% hit rate, no launch) and export the same XML and JSON."""
    import tempfile

    from repro_torch.core import model_io
    from repro_torch.core.isa import TEST_ISA

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        tmp = Path(tmp)
        qs = ROOT / "examples" / "quickstart_torch.py"
        (tmp / "card").mkdir()
        (tmp / "cpu").mkdir()
        card = _script(qs, {"TMPDIR": str(tmp / "card")})
        cpu = _script(qs, {"TMPDIR": str(tmp / "cpu"),
                           "REPRO_SIM_BACKEND": "torch",
                           "REPRO_SIM_DEVICES": "cpu"})
        card_out, card_launches, card_s = _finish(card, "quickstart (card)")
        cpu_out, cpu_launches, _ = _finish(cpu, "quickstart (CPU)")
        require(card_launches > 0, "the quickstart never launched the "
                "wave kernel")
        require(cpu_launches == 0, "the CPU quickstart launched a kernel")
        require(card_out.replace(str(tmp / "card"), "TMP")
                == cpu_out.replace(str(tmp / "cpu"), "TMP"),
                "the quickstart on the card prints other lines than on "
                "the CPU")
        require((tmp / "card" / "quickstart_model.xml").read_bytes()
                == (tmp / "cpu" / "quickstart_model.xml").read_bytes(),
                "the quickstart's model XML differs from the CPU's")
        log(f"[scripts] examples/quickstart_torch.py on the card: "
            f"{len(card_out.splitlines())} lines, equal to the CPU torch "
            f"backend's, {card_launches} wave-dispatch launches, "
            f"{card_s:.1f} s to exit")
        out["quickstart"] = {"launches": card_launches, "wall_s": card_s}

        def exported(root):
            mdir = root / "experiments" / "models"
            xml, js = {}, {}
            for name in models:
                xml[name] = (mdir / f"{name}.xml").read_text()
                js[name] = json.loads((mdir / f"{name}.json").read_text())
                js[name]["run_seconds"] = 0
            return xml, js

        scripts = {}
        for where in ("card", "cpu"):
            (tmp / where / "examples").mkdir(parents=True)
            scripts[where] = Path(shutil.copy(
                ROOT / "examples" / "export_models_torch.py",
                tmp / where / "examples"))
        cpu = _script(scripts["cpu"], {"REPRO_SIM_BACKEND": "torch",
                                       "REPRO_SIM_DEVICES": "cpu"})
        runs = []
        for label in ("cold", "warm"):
            stdout, launches, wall = _finish(_script(scripts["card"], {}),
                                             f"export_models ({label})")
            xml, js = exported(tmp / "card")
            for name, model in models.items():
                require(xml[name] == model_io.to_xml(model, TEST_ISA),
                        f"{label} export: {name}.xml differs from [main]")
            runs.append({"launches": launches, "wall_s": wall,
                         "hit_rates": _hit_rates(stdout), "json": js})
        _, cpu_launches, _ = _finish(cpu, "export_models (CPU)")
        cold, warm = runs
        cpu_xml, cpu_js = exported(tmp / "cpu")
        require(cpu_launches == 0, "the CPU export launched a kernel")
        require(cpu_xml == xml, "the CPU export's XML differs")
        require(cold.pop("json") == cpu_js, "the cold export's JSON differs "
                "from the CPU torch backend's")
        require(warm.pop("json") == cpu_js, "the warm export's JSON differs "
                "from the CPU torch backend's")
        require(cold["launches"] > 0, "the export never launched the wave "
                "kernel")
        require(warm["hit_rates"] == ["100.0%"] * len(models),
                f"warm export hit rates {warm['hit_rates']}")
        require(warm["launches"] == 0, "the warm export launched the wave "
                "kernel")
        log(f"[scripts] examples/export_models_torch.py on the card: cold "
            f"{cold['wall_s']:.1f} s to exit ({cold['launches']} launches, "
            f"hit rates {cold['hit_rates']}), warm {warm['wall_s']:.1f} s "
            f"(hit rates {warm['hit_rates']}, no launch); XML "
            f"byte-identical to [main] both times, JSON (run_seconds 0) "
            f"equal to the CPU torch backend's under one hash seed")
        out["export"] = {"cold": cold, "warm": warm}
    return out


class _Widest(list):
    """A ``launched_args`` sink that counts the launches, keeps only the
    widest one's inputs (by ``key``) and each launch's ``shape``."""

    def __init__(self, key, shape=None):
        super().__init__()
        self.key = key
        self.shape = shape
        self.n = 0
        self.shapes = []

    def append(self, args):
        self.n += 1
        if self.shape is not None:
            self.shapes.append(self.shape(args))
        if not self or self.key(args) > self.key(self[0]):
            self[:] = [args]


@contextlib.contextmanager
def _corpus_hooks(wave_sink, predict_sink, machines, predictors):
    """Every machine and predictor that ``evaluate_corpus`` builds in this
    block hands its kernel launches to the sinks and is kept, so their
    telemetry can be read afterwards."""
    from repro_torch.corpus import evaluate as ev
    sim, bpred = ev.SimMachine, ev.BatchPredictor

    class Machine(sim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.launched_args = wave_sink
            machines.append(self)

    class Predictor(bpred):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.launched_args = predict_sink
            predictors.append(self)

    ev.SimMachine, ev.BatchPredictor = Machine, Predictor
    try:
        yield
    finally:
        ev.SimMachine, ev.BatchPredictor = sim, bpred


def _row_bits(rows):
    return np.array([[r["measured"], r["predicted"]] for r in rows],
                    dtype=np.float64).view(np.int64)


def _stage_walls(events, uarches):
    """Per uarch, host seconds of the traced evaluation's stages: the
    ``corpus.uarch`` span, and inside its window characterization, ground
    truth (``predict.simulate``) and prediction (``predict.batch``)."""
    win = {e["args"]["uarch"]: (e["t0"], e["t0"] + e["dur"])
           for e in events if e["ph"] == "X" and e["name"] == "corpus.uarch"}
    out = {}
    for ua in uarches:
        lo, hi = win[ua]
        part = {"uarch_s": (hi - lo) / 1e9}
        for key, name in (("characterize_s", "characterize"),
                          ("ground_truth_s", "predict.simulate"),
                          ("predict_s", "predict.batch")):
            part[key] = sum(e["dur"] for e in events
                            if e["ph"] == "X" and e["name"] == name
                            and lo <= e["t0"] < hi) / 1e9
        out[ua] = part
    return out


def _artifact(results, *, scores_only=False):
    """The accuracy artifact as ``python -m repro_torch.corpus evaluate``
    writes it; ``scores_only`` drops the run's wave and engine counters."""
    from repro_torch.corpus import score_results
    art = score_results(results)
    if scores_only:
        art.pop("wave_stats", None)
        art.pop("engine_stats", None)
    return json.dumps(art, sort_keys=True, indent=1)


def _lanes_corpus(sub, firsts, results, cpu_models, out_dir):
    """``[lanes]`` on the corpus: the first ``sim_skl`` shard (in ``sub``)
    evaluated with the machine's waves on two logical devices of the card
    and the CPU-characterized model; its rows must equal ``[corpus]``'s
    (``results``) bit for bit."""
    from repro_torch.corpus import evaluate_corpus
    skl = next(s for s in firsts if s["uarch"] == "sim_skl")
    machines = []
    t0 = time.perf_counter()
    with _corpus_hooks(_Widest(lambda a: a[0].shape[1]),
                       _Widest(lambda a: a[0].shape[0]), machines, []):
        lanes = evaluate_corpus(
            sub, uarches=["sim_skl"], backend="cuda",
            devices=LANES_PLACEMENT, predict_backend="cuda",
            models={"sim_skl": cpu_models["sim_skl"]},
            wave_width=CORPUS_WAVE, out_dir=out_dir)
    seconds = time.perf_counter() - t0
    got = lanes["uarches"]["sim_skl"]
    want = results["uarches"]["sim_skl"][:skl["n_blocks"]]
    require([r["id"] for r in got] == [r["id"] for r in want]
            and np.array_equal(_row_bits(got), _row_bits(want)),
            f"[lanes] {skl['name']} on {LANES_PLACEMENT}: rows differ from "
            f"[corpus]'s")
    (m,) = machines
    st = m.device_stats()
    per = st["per_device"][LANES_PLACEMENT[0]]
    require(st["mesh"] is True and st["devices"] == list(LANES_PLACEMENT)
            and per["lanes"] >= skl["n_blocks"]
            and per["kernel_calls"] > st["kernel_calls"],
            f"[lanes] corpus machine placement {st}")
    log(f"[lanes] corpus: evaluate_corpus(devices={LANES_PLACEMENT}) on "
        f"{skl['name']} ({skl['n_blocks']} blocks): measured and predicted "
        f"float64 bits equal to [corpus]'s rows; {st['kernel_calls']} "
        f"chunks as {per['kernel_calls']} lane blocks, {seconds:.2f} s")
    return {"shard": skl["name"], "blocks": skl["n_blocks"],
            "seconds": seconds, "chunks": st["kernel_calls"],
            "lane_blocks": per["kernel_calls"]}


def phase_corpus():
    """The README's corpus evaluation on the card, at full width: seed 0,
    10,000 blocks a uarch on the three ``SIM_UARCHES``, shards of 2,048,
    wave width 2,048, ground truth through the wave-dispatch kernel and
    predictions through the port-bound kernel (traced: the walls of each
    stage come from the port's spans).  Then: a resumed run launches
    nothing and gives the same scores; the first shard of each uarch
    equals the CPU ``torch`` backend row for row, and ``sim_skl``'s on two
    logical devices of the card (``[lanes]``) equals the card's rows;
    ``sim_skl`` served over ``client_predict_fn`` gives the in-process
    artifact on both wires; and the widest launch of each kernel is held
    against its plain version."""
    import hashlib
    import tempfile

    from repro_torch.core import model_io
    from repro_torch.core.characterize import characterize
    from repro_torch.core.engine import as_engine
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    from repro_torch.corpus import (CorpusSpec, client_predict_fn,
                                    evaluate_corpus, generate_corpus)
    from repro_torch.corpus.store import MANIFEST, SHARD_DIR, read_shard
    from repro_torch.kernels import port_bound as pb
    from repro_torch.kernels import wave_dispatch as wd
    from repro_torch.obs import tracer as obs
    from repro_torch.service.client import local_service
    from repro_torch.service.protocol import parse_block

    spec = CorpusSpec()
    require((spec.seed, spec.blocks_per_uarch, spec.shard_size,
             spec.min_len, spec.max_len) == (0, 10_000, 2048, 2, 12)
            and set(spec.uarches) == set(SIM_UARCHES),
            f"the default spec is not the README's corpus: {spec}")
    card = torch.device("cuda:0")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        manifest = generate_corpus(tmp / "corpus", spec)
        gen_s = time.perf_counter() - t0
        cid = manifest["corpus_id"]
        log(f"[corpus] generated corpus {cid[:12]}: "
            f"{manifest['total_blocks']} blocks in "
            f"{len(manifest['shards'])} shards in {gen_s:.2f} s")

        # the main path, traced, its launches counted from 0
        wave_sink = _Widest(lambda a: a[0].shape[0] * a[0].shape[1])
        predict_sink = _Widest(lambda a: a[0].shape[0], _bcs)
        machines, predictors = [], []
        tracer = obs.Tracer(enabled=True)
        prev = obs.set_tracer(tracer)
        try:
            with _corpus_hooks(wave_sink, predict_sink, machines,
                               predictors):
                torch.cuda.synchronize()
                wd.launches = pb.launches = 0
                t0 = time.perf_counter()
                results = evaluate_corpus(
                    tmp / "corpus", backend="cuda", device=card,
                    predict_backend="cuda", wave_width=CORPUS_WAVE,
                    out_dir=tmp / "results")
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
                launches = {"wave_dispatch": wd.launches,
                            "port_bound": pb.launches}
                pb_shapes = list(predict_sink.shapes)
            events = tracer.events()
        finally:
            obs.set_tracer(prev)
        require(launches["wave_dispatch"] > 0, "the corpus never launched "
                "the wave kernel")
        require(launches["port_bound"] > 0, "the corpus never launched the "
                "port-bound kernel")
        require(launches["wave_dispatch"] == wave_sink.n
                and launches["port_bound"] == predict_sink.n,
                f"launches {launches} vs kept {wave_sink.n}, "
                f"{predict_sink.n}")
        es, ws = results["engine_stats"], results["wave_stats"]
        require(es["quarantined"] == 0, f"quarantined {es['quarantined']}")
        require(es["degraded_chunks"] == 0,
                f"degraded chunks {es['degraded_chunks']}")
        kernel_ns = {}
        for m in machines:
            st = m.device_stats()
            require(st["backend"] == "cuda" and st["kernel_calls"] > 0,
                    f"{m.name}: no kernel call on the cuda backend")
            require(m.degraded_stats() == {}, f"{m.name} degraded")
            require(set(st.get("kernel_ns", {})) == {"device:cuda:0"},
                    f"{m.name}: traced waves reported kernel_ns "
                    f"{st.get('kernel_ns')}")
            kernel_ns[m.name] = st["kernel_ns"]["device:cuda:0"]
        for bp in predictors:
            st = bp.backend_stats()
            require(st["backend"] == "cuda" and st["device_waves"] > 0,
                    f"predictor stats {st}")
            require(st["device_fallbacks"] == 0,
                    f"{st['device_fallbacks']} device fallbacks")
        art = _artifact(results)
        sha = hashlib.sha256(art.encode()).hexdigest()
        walls = _stage_walls(events, sorted(results["uarches"]))
        scores = json.loads(art)["uarches"]
        for ua, w in walls.items():
            sc = scores[ua]
            log(f"[corpus] {ua}: {sc['n']} blocks, characterize "
                f"{w['characterize_s']:.2f} s, ground truth "
                f"{w['ground_truth_s']:.2f} s, prediction "
                f"{w['predict_s']:.2f} s (uarch {w['uarch_s']:.2f} s), "
                f"wave kernel {kernel_ns[ua] / 1e6:.2f} ms on the card "
                f"(kernel_ns); MAPE {sc['mape']:.6f} tau-b "
                f"{sc['kendall_tau']:.6f}")
        log(f"[corpus] evaluate_corpus on cuda: {eval_s:.2f} s wall, "
            f"{ws['waves']} waves (max width {ws['max_wave_width']}), "
            f"{launches['wave_dispatch']} wave-dispatch and "
            f"{launches['port_bound']} port-bound launches; "
            f"{es['executions']} executions, {es['machine_runs']} machine "
            f"runs, quarantined 0, no degraded chunk, no device fallback; "
            f"artifact sha256 {sha[:16]}")

        # resumed: every shard's rows from its result file, no launch
        before = wd.launches, pb.launches
        t0 = time.perf_counter()
        again = evaluate_corpus(tmp / "corpus", backend="cuda", device=card,
                                predict_backend="cuda",
                                wave_width=CORPUS_WAVE,
                                out_dir=tmp / "results")
        resume_s = time.perf_counter() - t0
        require((wd.launches, pb.launches) == before,
                "the resumed run launched a kernel")
        require(again["wave_stats"]["waves"] == 0, "the resumed run ran a "
                "wave")
        require(_artifact(again, scores_only=True)
                == _artifact(results, scores_only=True),
                "the resumed run's artifact differs")
        log(f"[corpus] resumed run: {resume_s:.2f} s, no wave, no launch, "
            f"artifact byte-identical but for its wave_stats/engine_stats")

        # the first shard of each uarch on the CPU torch backend, with
        # models characterized on the CPU over the same variants
        firsts = [next(s for s in manifest["shards"] if s["uarch"] == ua)
                  for ua in sorted(spec.uarches)]
        sub = tmp / "first_shards"
        (sub / SHARD_DIR).mkdir(parents=True)
        for s in firsts:
            shutil.copy(tmp / "corpus" / SHARD_DIR / s["name"],
                        sub / SHARD_DIR)
        (sub / MANIFEST).write_text(json.dumps(dict(
            manifest, shards=firsts,
            total_blocks=sum(s["n_blocks"] for s in firsts))))
        t0 = time.perf_counter()
        cpu_models = {}
        for ua in sorted(spec.uarches):
            used = sorted({ins.spec for s in manifest["shards"]
                           if s["uarch"] == ua
                           for r in read_shard(tmp / "corpus", s)
                           for ins in parse_block(r["block"])})
            cpu_models[ua] = characterize(as_engine(SimMachine(
                SIM_UARCHES[ua], TEST_ISA, backend="torch", device="cpu")),
                TEST_ISA, used)
        cpu = evaluate_corpus(sub, backend="torch", device="cpu",
                              predict_backend="torch", models=cpu_models,
                              wave_width=CORPUS_WAVE, out_dir=tmp / "cpu")
        cpu_s = time.perf_counter() - t0
        for s in firsts:
            ua, n = s["uarch"], s["n_blocks"]
            got, want = results["uarches"][ua][:n], cpu["uarches"][ua]
            require([r["id"] for r in got] == [r["id"] for r in want],
                    f"{ua}: first shard ids differ")
            require(np.array_equal(_row_bits(got), _row_bits(want)),
                    f"{ua}: first shard rows differ from the CPU")
        log(f"[corpus] CPU cross-check: the first shard of each uarch "
            f"({', '.join(s['name'] for s in firsts)}, "
            f"{sum(s['n_blocks'] for s in firsts)} blocks), measured and "
            f"predicted float64 bits equal to the CPU torch backend "
            f"(characterization and evaluation {cpu_s:.1f} s on the CPU)")

        out_lanes = _lanes_corpus(sub, firsts, results, cpu_models,
                                  tmp / "lanes")

        # sim_skl served over both wires, against the in-process path
        mdir = tmp / "models"
        mdir.mkdir()
        xml = model_io.to_xml(cpu_models["sim_skl"], TEST_ISA)
        (mdir / "sim_skl.xml").write_text(xml)
        skl = {"sim_skl": model_io.load_xml(xml)}

        def run(name, predict_fn=None):
            return _artifact(evaluate_corpus(
                tmp / "corpus", uarches=["sim_skl"], models=skl,
                backend="cuda", device=card, predict_backend="cuda",
                wave_width=CORPUS_WAVE, out_dir=tmp / name,
                predict_fn=predict_fn))

        # both sides load the model from the same XML, which rounds its
        # values: the scores are the served model's, not the main run's
        t0 = time.perf_counter()
        inproc = run("inproc")
        for wire in ("json", "binary"):
            with local_service(mdir, wire=wire,
                               predict_backend="cuda") as client:
                require(client.wire == wire, f"wire {client.wire}")
                served = run(f"served_{wire}", client_predict_fn(client))
                st = client.stats()["predictor"]
            require(served == inproc, f"{wire} wire: the served artifact "
                    "differs from the in-process one")
            require(st["device_waves"] > 0 and st["device_fallbacks"] == 0,
                    f"{wire} wire predictor stats {st}")
        served_s = time.perf_counter() - t0
        log(f"[corpus] sim_skl through client_predict_fn "
            f"over local_service(predict_backend='cuda'): artifact "
            f"byte-identical to the in-process one on the json and binary "
            f"wires ({served_s:.1f} s for the three runs)")

        # the widest launch of each kernel against its plain version
        (args,) = wave_sink
        err = kernel_vs_plain(args)
        S, E, R = args[5].shape
        bound_ms, bound_by = _bound_ms(args)
        wide_wave = {"shape_SER": [S, E, R], "max_abs_err": err,
                     "ms": _time_ms(wd.wave_dispatch, args, reps=10),
                     "device_ms": _device_ms(wd.wave_dispatch, args, 10,
                                             bound_ms),
                     "plain_ms": _time_ms(wd.wave_dispatch_ref, args, 1),
                     "bound_ms": bound_ms, "bound_by": bound_by}
        (pargs,) = predict_sink
        perr = port_bound_vs_plain(pargs)
        B, C = pargs[0].shape
        Sc = pargs[1].shape[1]
        pbound, pby = _bound(_port_bound_bytes(B, C, Sc),
                             _port_bound_ops(*pargs),
                             H100_SXM["peak_fp32_flops"])
        wide_pb = {"shape_BCS": [B, C, Sc], "max_abs_err": perr,
                   "ms": _time_ms(pb.port_bound, pargs, reps=50),
                   "device_ms": _device_ms(pb.port_bound, pargs, 50, pbound),
                   "plain_ms": _time_ms(pb.port_bound_ref, pargs, 1),
                   "bound_ms": pbound, "bound_by": pby}
        log(f"[corpus] widest wave-dispatch launch S={S} E={E} R={R}: "
            f"equal to the plain version; device {wide_wave['device_ms']:.4f}"
            f" ms a launch, plain {wide_wave['plain_ms']:.2f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}); widest port-bound launch "
            f"B={B} C={C} S={Sc}: equal to the plain version; device "
            f"{wide_pb['device_ms']:.4f} ms, plain "
            f"{wide_pb['plain_ms']:.3f} ms, bound {pbound:.6f} ms ({pby})")
        out = {"corpus_id": cid, "blocks": manifest["total_blocks"],
               "shards": len(manifest["shards"]),
               "waves": ws["waves"], "max_wave_width": ws["max_wave_width"],
               "generate_s": gen_s, "evaluate_s": eval_s,
               "resume_s": resume_s, "cpu_check_s": cpu_s,
               "served_check_s": served_s, "stages_s": walls,
               "wave_kernel_ns": kernel_ns, "launches": launches,
               "port_bound_launches_BCS": pb_shapes,
               "engine_stats": es, "artifact_sha256": sha,
               "scores": {ua: {"mape": sc["mape"],
                               "kendall_tau": sc["kendall_tau"]}
                          for ua, sc in scores.items()},
               "widest_wave_dispatch": wide_wave,
               "widest_port_bound": wide_pb, "lanes": out_lanes}
    return out, tracer


# ---------------------------------------------------------- trace report
def phase_trace_report(tracer, corpus, smi):
    """The ``[corpus]`` phase's trace through the port's exporter and wave
    report: written as Chrome trace-event JSON and as JSONL, each read back
    with ``load_events`` (the same ``ph``, ``name``, ``ts_us``, ``dur_us``
    and ``args`` event for event; the Chrome format renumbers ``tid``s),
    and the report built from each file (equal).  The ``kernel`` stage
    holds one span per traced wave-dispatch launch, the one device track
    ``device:cuda:0`` is busy for the executors' ``kernel_ns`` (the span
    carries the kernel's CUDA-event interval), and a bottleneck is
    named."""
    import tempfile

    from repro_torch.analysis.wave_report import (format_wave_report,
                                                  wave_report)
    from repro_torch.obs.export import (load_events, write_chrome_trace,
                                        write_jsonl)

    launches = corpus["launches"]["wave_dispatch"]
    kernel_us = sum(corpus["wave_kernel_ns"].values()) / 1e3
    keys = ("ph", "name", "ts_us", "dur_us", "args")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        t0 = time.perf_counter()
        paths = (write_chrome_trace(Path(tmp) / "corpus.trace.json", tracer),
                 write_jsonl(Path(tmp) / "corpus.trace.jsonl", tracer))
        sizes = [os.path.getsize(p) for p in paths]
        loaded = [load_events(p) for p in paths]
        io_s = time.perf_counter() - t0
    require(len(loaded[0]) == len(loaded[1]) == len(tracer.events()) > 0,
            f"events read back {[len(e) for e in loaded]} of "
            f"{len(tracer.events())}")
    require([[e[k] for k in keys] for e in loaded[0]]
            == [[e[k] for k in keys] for e in loaded[1]],
            "the two formats read back different events")
    reps = [wave_report(e) for e in loaded]
    require(reps[0] == reps[1], "the two formats give different reports")
    rep = reps[0]
    kernel = rep["stages"]["kernel"]
    require(kernel["count"] == launches,
            f"{kernel['count']} kernel spans for {launches} traced "
            f"wave-dispatch launches")
    require(set(rep["devices"]) == {"device:cuda:0"},
            f"device tracks {sorted(rep['devices'])}")
    busy_us = rep["devices"]["device:cuda:0"]
    require(abs(busy_us - kernel_us) <= 1e-3,
            f"device busy {busy_us} us against kernel_ns {kernel_us} us")
    require(rep["bottleneck"] not in ("", "idle"),
            f"bottleneck {rep['bottleneck']!r}")
    log(f"[trace-report] the [corpus] trace: {len(loaded[0])} events, "
        f"{sizes[0]} bytes as Chrome JSON, {sizes[1]} as JSONL (written "
        f"and read back in {io_s:.2f} s), the same events and report from "
        f"both; {kernel['count']} kernel spans = {launches} traced "
        f"launches; device:cuda:0 busy {busy_us:.3f} us = kernel_ns "
        f"{kernel_us:.3f} us ({smi})")
    for line in format_wave_report(rep).splitlines():
        log(f"[trace-report] {line}")
    return {"events": len(loaded[0]), "bytes_chrome": sizes[0],
            "bytes_jsonl": sizes[1], "kernel_spans": kernel["count"],
            "device_busy_us": busy_us, "kernel_ns_us": kernel_us,
            "bottleneck": rep["bottleneck"],
            "stages_us": {k: v["us"] for k, v in rep["stages"].items()
                          if v["count"]},
            "lock_wait_share": rep["lock_wait"]["share"],
            "wall_us": rep["wall_us"]}


# ---------------------------------------------------------- model serving
# (arch, depth cut: {field: value} or {}, batch, prefill positions, decode
# steps); SmolLM-360M uncut, the other families at full width
MODELS = (("smollm_360m", {}, 8, 128, 64),
          ("qwen2_vl_2b", {"num_layers": 4}, 2, 256, 8),
          ("phi3_5_moe_42b", {"num_layers": 2}, 2, 256, 8),
          ("mamba2_2_7b", {"num_layers": 4}, 2, 256, 8),
          ("zamba2_2_7b", {"num_layers": 6}, 2, 256, 8))
MODEL_SEED = 0
# prefill(S) + decode(1) against prefill(S + 1), f32 compute on the card:
# the reference's own consistency tolerance (tests/test_models_smoke.py)
CONSISTENCY_TOL = 2e-3
# the card against the CPU, f32 compute, on the same weights and inputs
CARD_CPU_TOL = 1e-3
CHECK_LAYERS = 2         # depth of the card = CPU check
CHECK_SEQ = 64           # positions of both checks
PROFILE_STEPS = 4        # decode steps under torch.profiler
PREFILL_RUNS = 3         # timed prefills, their median reported


def _on(model, cfg, device=None, layers=None):
    """``model``'s weights under ``cfg`` (shared, or copied to ``device``),
    every stacked layer dimension (``layers``, an encoder-decoder's
    ``enc_layers`` and ``dec_layers``) cut to its first ``layers``."""
    from repro_torch.models.model import build_model
    m = build_model(cfg, device="meta")
    stacked = ("layers.", "enc_layers.", "dec_layers.")
    sd = {k: (v[:layers] if layers and k.startswith(stacked) else v)
          for k, v in model.state_dict().items()}
    m.load_state_dict({k: v.to(device) if device else v
                       for k, v in sd.items()}, strict=True, assign=True)
    return m


def _model_batch(cfg, B, seq, device, gen):
    """``B`` rows of ``seq`` random tokens; a VLM row is
    ``num_patch_tokens`` random patch embeddings, then the tokens."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, seq),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = 0.02 * torch.randn(
            (B, cfg.num_patch_tokens, cfg.d_model), generator=gen,
            device=device)
    return batch


def _rows(batch, n):
    return {k: v[:n] for k, v in batch.items()}


def phase_models(smi):
    """The model substrate's serving path on the card, through the entry
    points a user calls (``build_model``, ``init``, ``generate``,
    ``prefill``, ``decode_step``): SmolLM-360M uncut (f32 weights, bf16
    compute), 8 x 128 tokens then 64 greedy decode steps; one config of
    each other family at full width with its depth cut, 2 x 256 positions
    then 8 steps.  Each must give finite logits; the same weights in f32
    compute must continue a prefill by a decode step as a prefill one
    token longer does (``CONSISTENCY_TOL``), and must give the CPU's
    logits at ``CHECK_LAYERS`` layers (``CARD_CPU_TOL``)."""
    out = []
    for arch, cut, B, S, steps in MODELS:
        torch.cuda.empty_cache()
        out.append(_serve_model(arch, cut, B, S, steps, smi))
    return out


def _device_us(prof, operators=False):
    """{name: (self device µs, count)} of a ``torch.profiler`` window:
    the device's own events (kernels, copies, fills), or with
    ``operators`` the operators that launched them, each with the device
    time of its own kernels.  ``key_averages()`` holds both, and each
    kernel's time once in each: sum one kind only.  The program's span
    ranges (``record_function`` user annotations, which the span tracer
    opens under a profiler, and their device shadows spanning whole
    waves) are neither, and are left out."""
    from torch.autograd import DeviceType
    out = {}
    for item in prof.key_averages():
        if (item.device_type == DeviceType.CPU) != operators or getattr(
                item, "is_user_annotation", False):
            continue
        us = getattr(item, "self_device_time_total", None)
        if us is None:
            us = getattr(item, "self_cuda_time_total", 0)
        if us:
            out[item.key] = (us, item.count)
    return out


def _device_busy(prof):
    """(device-busy seconds, kernel launches) of a ``torch.profiler``
    window, or (None, None) when it recorded no device time."""
    times = _device_us(prof).values()
    busy = sum(us for us, _ in times) / 1e6
    return (busy, sum(n for _, n in times)) if busy else (None, None)


def _serve_model(arch, cut, B, S, steps, smi):
    """One configuration of :func:`phase_models`; everything it allocates
    on the card is freed when it returns."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import load_config
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import generate, make_serve_step

    card = torch.device("cuda:0")
    full = load_config(arch)
    cfg = full.replace(**cut)
    gen = torch.Generator(device=card).manual_seed(MODEL_SEED)
    before = torch.cuda.memory_allocated()   # what earlier phases hold
    model = build_model(cfg, device=card).init(gen)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()   # serving's peak, not init's
    batch = _model_batch(cfg, B, S, card, gen)
    positions = S + (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    # generate's decode headroom, S + (steps + 1) + 8, over all positions
    pad = positions + steps + 9
    step = make_serve_step(model)
    # warm-up at the timed shapes: the first calls pay cuBLAS and
    # allocator set-up; the prefill launches the SSD kernel once a Mamba2
    # layer (models/mamba.py:ssd_route)
    sd.launches = 0
    lg, st = model.prefill(batch, pad_to=pad)
    ssd_launches = sd.launches
    want = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    require(ssd_launches == want, f"{arch}: a prefill launched the SSD "
            f"kernel {ssd_launches} times, not {want}")
    step(st, torch.argmax(lg, -1).to(torch.int32))
    del lg, st
    prefill_runs = []
    for _ in range(PREFILL_RUNS):
        logits = state = None   # the previous run's state is freed first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(batch, pad_to=pad)
        torch.cuda.synchronize()
        prefill_runs.append(time.perf_counter() - t0)
    prefill_s = float(np.median(prefill_runs))
    require(bool(torch.isfinite(logits).all()),
            f"{arch}: prefill logits not finite")
    tok = torch.argmax(logits, -1).to(torch.int32)
    ids = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, lg, state = step(state, tok)
        ids.append(tok)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    require(bool(torch.isfinite(lg).all()),
            f"{arch}: decode logits not finite")
    ids = torch.stack(ids, dim=1)
    peak = torch.cuda.max_memory_allocated()
    # the device time of PROFILE_STEPS more decode steps, over the
    # unprofiled steps' wall time: the profiler's host overhead stretches
    # its own window, not the device work
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            tok, lg, state = step(state, tok)
        torch.cuda.synchronize()
    busy_s, kernels = _device_busy(prof)
    busy_share = (None if busy_s is None
                  else busy_s / (PROFILE_STEPS * decode_ms / 1e3))
    gen_s = None
    if cfg.family != "vlm":
        # generate pads S + steps + 8 text positions, short of a VLM's
        # patch positions (the reference's generate does the same)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = generate(model, batch, steps + 1)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        require(torch.equal(got, ids), f"{arch}: generate's ids differ "
                f"from prefill + {steps} serve steps")

    # prefill/decode consistency, f32 compute, on the card
    cfg32 = cfg.replace(compute_dtype=torch.float32,
                        capacity_factor=max(cfg.capacity_factor, 8.0))
    m32 = _on(model, cfg32)
    chk = _model_batch(cfg, 2, CHECK_SEQ + 1, card, gen)
    short = dict(chk, tokens=chk["tokens"][:, :-1])
    chk_pad = positions - S + CHECK_SEQ + 1
    _, st = m32.prefill(short, pad_to=chk_pad)
    got, _ = m32.decode_step(st, chk["tokens"][:, -1])
    want, _ = m32.prefill(chk)
    cons = float((got - want).abs().max())
    require(bool(torch.allclose(got, want, atol=CONSISTENCY_TOL,
                                rtol=CONSISTENCY_TOL)),
            f"{arch}: decode after prefill differs from a longer prefill "
            f"by {cons}")

    # the card against the CPU, f32 compute, CHECK_LAYERS layers (the
    # hybrid's smallest depth is one super-block)
    layers = (None if cfg.family == "hybrid"
              else min(CHECK_LAYERS, cfg.num_layers))
    cfg_chk = cfg.replace(compute_dtype=torch.float32,
                          num_layers=layers or cfg.num_layers)
    m_card = _on(model, cfg_chk, layers=layers)
    m_cpu = _on(model, cfg_chk, device="cpu", layers=layers)
    lg_card, st_card = m_card.prefill(short, pad_to=chk_pad)
    lg_cpu, st_cpu = m_cpu.prefill({k: v.cpu() for k, v in short.items()},
                                   pad_to=chk_pad)
    nxt = chk["tokens"][:, -1]
    dg_card, _ = m_card.decode_step(st_card, nxt)
    dg_cpu, _ = m_cpu.decode_step(st_cpu, nxt.cpu())
    pairs = ((lg_card.cpu(), lg_cpu), (dg_card.cpu(), dg_cpu))
    errs = [float((a - b).abs().max()) for a, b in pairs]
    require(all(torch.allclose(a, b, atol=CARD_CPU_TOL, rtol=CARD_CPU_TOL)
                for a, b in pairs),
            f"{arch}: card and CPU logits differ by {errs}")

    cuts = (f"{cfg.num_layers} of {full.num_layers} layers" if cut
            else "uncut")
    tok_s = B * positions / prefill_s
    via = (f"generate's ids equal ({gen_s:.3f} s for prefill and {steps} "
           f"steps)" if gen_s is not None else
           "generate not run: its padding misses the patch positions")
    busy = ("the profiler recorded no device time" if busy_s is None else
            f"device busy {100 * busy_share:.1f}% of a step: device time of "
            f"{PROFILE_STEPS} profiled steps over {PROFILE_STEPS} unprofiled "
            f"steps' wall time, {kernels / PROFILE_STEPS:.0f} kernels a "
            f"step")
    log(f"[models] {full.name} ({cfg.family}, {cuts}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, f32 weights, bf16 "
        f"compute): prefill {B} x {positions} positions in {prefill_s:.4f} "
        f"s (median of {PREFILL_RUNS}, {tok_s:.0f} tokens/s), {steps} greedy decode steps at "
        f"{decode_ms:.2f} ms a step ({busy}), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB: {params / 2**30:.2f} GiB of weights, "
        f"{(peak - before - params) / 2**30:.2f} GiB of serving, "
        f"{before / 2**30:.2f} GiB held before the model ({smi}); {via}; "
        f"ssd_scan launches in a prefill {ssd_launches}")
    log(f"[models] {full.name}: finite logits; f32 prefill({CHECK_SEQ}) + "
        f"decode(1) vs prefill({CHECK_SEQ + 1}) max |d| {cons:.3g} (tol "
        f"{CONSISTENCY_TOL}); card vs CPU at {cfg_chk.num_layers} layers, "
        f"f32, prefill max |d| {errs[0]:.3g}, decode max |d| {errs[1]:.3g} "
        f"(tol {CARD_CPU_TOL}) ({smi})")
    return {"arch": arch, "name": full.name, "family": cfg.family,
            "cut": cut or None, "batch": B, "positions": positions,
            "decode_steps": steps, "prefill_s": prefill_s,
            "prefill_runs_s": prefill_runs,
            "prefill_tokens_per_s": tok_s, "decode_ms_per_step": decode_ms,
            "prefill_ssd_launches": ssd_launches,
            "generate_s": gen_s, "peak_bytes": peak, "weight_bytes": params,
            "bytes_before_model": before,
            "device_busy_share": busy_share,
            "kernels_per_step": (None if kernels is None
                                 else kernels / PROFILE_STEPS),
            "consistency_max_abs": cons, "card_cpu_max_abs": errs,
            "card_cpu_layers": cfg_chk.num_layers, "card": smi}


# ---------------------------------------------------------------- training
# SmolLM-360M uncut through the trainer's entry point, launch.train.train:
# f32 weights and AdamW state, bf16 compute, remat "full"
TRAIN_ARCH = "smollm_360m"
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME_AT = 30, 10, 10
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 10, "total_steps": TRAIN_STEPS}
# a resumed run against the uninterrupted one: the reference test's
# tolerance (tests/test_substrate.py::test_train_resume_from_checkpoint)
RESUME_ATOL, RESUME_RTOL = 2e-4, 2e-3
TIMED_TRAIN_STEPS = 5    # synchronised steps, their median reported
PROFILED_TRAIN_STEPS = 2
# (arch, depth cut, batch, text positions): the other families at full
# width, two train steps each through make_train_step
TRAIN_MODELS = (("qwen2_vl_2b", {"num_layers": 4}, 2, 256),
                ("phi3_5_moe_42b", {"num_layers": 2}, 2, 256),
                ("mamba2_2_7b", {"num_layers": 4}, 2, 256),
                ("zamba2_2_7b", {"num_layers": 6}, 2, 256),
                ("whisper_medium", {"num_layers": 2,
                                    "num_decoder_layers": 2}, 2, 256))
TRAIN_FAMILY_STEPS = 2
# a cut whose weights, gradients, AdamW moments and the update's
# temporaries (4 x the weights + 4 x the largest leaf) would pass this
# runs one layer fewer
TRAIN_PEAK_LIMIT = 70 * 2**30
# one loss.backward() on the card against the CPU, f32 compute, TF32 off
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 1e-3
TRAIN_SEED = 0


def _gnorms(lines):
    return [float(m.group(1)) for line in lines
            for m in [re.search(r"gnorm=(\S+)", line)] if m]


def _loss_grads(model, batch):
    model.requires_grad_(True)
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def _card_vs_cpu(arch, model, cfg, batch):
    """One loss.backward() at CHECK_LAYERS layers (the hybrid: one
    super-block) in f32 compute on the card and on the CPU, the same
    weights and batch: (loss rel. difference, worst leaf's max |d| over
    its max |g|, layers)."""
    layers = (None if cfg.family == "hybrid"
              else min(CHECK_LAYERS, cfg.num_layers))
    cut = {"compute_dtype": torch.float32}
    if layers:
        cut["num_layers"] = layers
        if cfg.family == "encdec":
            cut["num_decoder_layers"] = min(layers, cfg.num_decoder_layers)
    cfg_chk = cfg.replace(**cut)
    m_card = _on(model, cfg_chk, layers=layers)
    loss_card, g_card = _loss_grads(m_card, batch)
    g_card = {k: v.cpu() for k, v in g_card.items()}
    del m_card
    torch.cuda.empty_cache()
    m_cpu = _on(model, cfg_chk, "cpu", layers)
    loss_cpu, g_cpu = _loss_grads(m_cpu, {k: v.cpu()
                                          for k, v in batch.items()})
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max(float((g_card[k] - g).abs().max()) /
                max(float(g.abs().max()), 1e-30) for k, g in g_cpu.items())
    require(loss_rel <= TRAIN_LOSS_REL,
            f"{arch}: card and CPU losses differ by {loss_rel:.3g} (rel)")
    require(worst <= TRAIN_GRAD_REL,
            f"{arch}: card and CPU gradients differ by {worst:.3g} of a "
            "leaf's largest")
    return loss_rel, worst, cfg_chk.num_layers


def phase_train(smi):
    """Training on the card through the trainer's entry points.

    SmolLM-360M uncut through ``launch.train.train(device="cuda")``:
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens of the synthetic pipeline,
    ``TRAIN_STEPS`` steps with a checkpoint every ``TRAIN_CKPT_EVERY``; the
    loss must fall and every gradient norm be finite.  A run to step 20
    resumed from the step-10 checkpoint must equal the uninterrupted run's
    step-20 checkpoint (``RESUME_ATOL``/``RESUME_RTOL``).  Then timed and
    profiled steps of the same model.  Each config of ``TRAIN_MODELS``
    (the other families at full width, depth cut) trains
    ``TRAIN_FAMILY_STEPS`` steps through ``make_train_step``, and one
    backward of each family (SmolLM included) equals the CPU's in f32
    (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_REL``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree_util import tree_leaves

    t_phase = time.perf_counter()
    card = torch.device("cuda:0")
    cfg = load_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": TRAIN_ARCH, "name": cfg.name, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "card": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        run_a, run_b = Path(tmp) / "a", Path(tmp) / "b"
        logged = []   # (host time, line): a step's line follows its sync
        t0 = time.perf_counter()
        model, state, losses = train(
            cfg, shape, steps=TRAIN_STEPS, opt_cfg=opt, ckpt_dir=run_a,
            ckpt_interval=TRAIN_CKPT_EVERY, log_every=1,
            log_fn=lambda line: logged.append((time.perf_counter(), line)),
            seed=TRAIN_SEED, device=card)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        lines = [line for _, line in logged]
        # from the start to the last step's line: init and every step
        # (with the snapshots of steps 10 and 20 and the waits for a
        # running save); after it: the last save
        steps_s = logged[-1][0] - t0
        peak = torch.cuda.max_memory_allocated()
        weights = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves((state.mu, state.nu)))
        gnorms = _gnorms(lines)
        require(len(losses) == TRAIN_STEPS == len(gnorms),
                f"train logged {len(losses)} losses, {len(gnorms)} norms")
        require(all(np.isfinite(g) for g in gnorms),
                f"a gradient norm is not finite: {gnorms}")
        require(losses[-1][1] < losses[0][1],
                f"the loss did not fall: {losses[0][1]} -> {losses[-1][1]}")
        ckpts = sorted(p.name for p in run_a.iterdir())
        log(f"[train] {cfg.name} uncut (d_model {cfg.d_model}, "
            f"{cfg.num_layers} layers, vocab {cfg.vocab_size}, f32 weights "
            f"and AdamW state, bf16 compute, remat {cfg.remat}) through "
            f"launch.train.train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} in {run_s:.1f} s ({steps_s:.1f} s to the last "
            f"step's log line, {run_s - steps_s:.1f} s then for the last "
            f"checkpoint; checkpoints {ckpts}); loss "
            f"{losses[0][1]:.4f} -> {losses[-1][1]:.4f}, gnorm "
            f"{min(gnorms):.3f}..{max(gnorms):.3f}, all finite ({smi})")

        # timed and profiled steps of the trained model, past its schedule
        step_fn = make_train_step(model, opt)
        data = SyntheticTokens(cfg, shape, DataConfig(
            seed=TRAIN_SEED, vocab_size=min(cfg.vocab_size, 512)),
            device=card)
        times = []
        for i in range(TIMED_TRAIN_STEPS):
            batch = data.batch_at(TRAIN_STEPS + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, metrics = step_fn(model, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms = 1e3 * _median(times)
        batches = [data.batch_at(TRAIN_STEPS + TIMED_TRAIN_STEPS + i)
                   for i in range(PROFILED_TRAIN_STEPS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for batch in batches:
                _, state, metrics = step_fn(model, state, batch)
            torch.cuda.synchronize()
        busy_s, kernels = _device_busy(prof)
        busy = (None if busy_s is None else
                busy_s / (PROFILED_TRAIN_STEPS * step_ms / 1e3))
        # the operators whose kernels hold the card longest, device ms
        # and calls a step
        top = [(k, us / 1e3 / PROFILED_TRAIN_STEPS, n / PROFILED_TRAIN_STEPS)
               for k, (us, n) in sorted(
                   _device_us(prof, operators=True).items(),
                   key=lambda kv: -kv[1][0])[:8]]
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
        require(bool(torch.isfinite(metrics["loss"])),
                "a timed step's loss is not finite")
        busy_text = ("the profiler recorded no device time" if busy_s is None
                     else f"device busy {100 * busy:.1f}% of a step "
                     f"({PROFILED_TRAIN_STEPS} profiled steps' device time "
                     f"over the median step's wall, "
                     f"{kernels / PROFILED_TRAIN_STEPS:.0f} kernels a step)")
        log(f"[train] {cfg.name}: {step_ms:.1f} ms a train step (median of "
            f"{TIMED_TRAIN_STEPS} synchronised, {min(times) * 1e3:.1f}-"
            f"{max(times) * 1e3:.1f}), {tok_s:.0f} tokens/s, {busy_text}; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB over "
            f"{(weights + state_bytes) / 2**30:.2f} GiB of weights "
            f"({weights / 2**30:.2f}) and AdamW state, "
            f"{before / 2**30:.2f} GiB held before ({smi})")
        log(f"[train] {cfg.name}: the operators longest on the card, "
            f"their kernels' device ms and calls a step: " + ("; ".join(
                f"{k[:60]} {ms:.2f} ms x {n:.0f}" for k, ms, n in top)
                if top else "not measured (no device time recorded)"))
        out.update(run_s=run_s, run_steps_s=steps_s, losses=losses, grad_norms=gnorms,
                   step_ms=step_ms, step_runs_ms=[1e3 * t for t in times],
                   tokens_per_s=tok_s, device_busy_share=busy,
                   kernels_per_step=(None if kernels is None
                                     else kernels / PROFILED_TRAIN_STEPS),
                   top_operators=[{"name": k, "device_ms_per_step": ms,
                                   "calls_per_step": n}
                                  for k, ms, n in top],
                   peak_bytes=peak, weight_bytes=weights,
                   adamw_state_bytes=state_bytes, bytes_before=before)
        del model, state, step_fn, metrics, batches, prof

        # resume: step 10's checkpoint, run to step 20, against step 20's
        run_b.mkdir()
        ckpt = f"{TRAIN_RESUME_AT:08d}.ckpt"
        shutil.copytree(run_a / ckpt, run_b / ckpt)
        resumed = []
        t0 = time.perf_counter()
        model, state, _ = train(
            cfg, shape, steps=2 * TRAIN_RESUME_AT, opt_cfg=opt,
            ckpt_dir=run_b, ckpt_interval=TRAIN_CKPT_EVERY, log_every=5,
            log_fn=resumed.append, seed=TRAIN_SEED, device=card)
        resume_s = time.perf_counter() - t0
        require(resumed and resumed[0] ==
                f"[train] resumed from step {TRAIN_RESUME_AT}",
                f"the run did not resume: {resumed[:1]}")
        step, want, _ = restore_checkpoint(
            run_a / f"{2 * TRAIN_RESUME_AT:08d}.ckpt", (model, state))
        require(step == 2 * TRAIN_RESUME_AT, f"checkpoint step {step}")
        diffs = [(float((a - b).abs().max()), bool(torch.equal(a, b)),
                  bool(torch.allclose(a, b, atol=RESUME_ATOL,
                                      rtol=RESUME_RTOL)))
                 for a, b in zip((t.detach().float() for t in
                                  tree_leaves((model, state))),
                                 (t.float() for t in tree_leaves(want)))]
        resume_max = max(d[0] for d in diffs)
        identical = all(d[1] for d in diffs)
        require(all(d[2] for d in diffs),
                f"the resumed run differs from the uninterrupted one by "
                f"{resume_max:.3g} (atol {RESUME_ATOL}, rtol {RESUME_RTOL})")
        log(f"[train] {cfg.name}: resumed at step {TRAIN_RESUME_AT} from its "
            f"checkpoint, {TRAIN_RESUME_AT} steps to {2 * TRAIN_RESUME_AT} "
            f"in {resume_s:.1f} s: params and AdamW state "
            + ("bit-identical to" if identical else
               f"within {resume_max:.3g} of (not bit-identical: the card's "
               f"kernels are not run-to-run deterministic here; tolerance "
               f"atol {RESUME_ATOL}, rtol {RESUME_RTOL}, the reference "
               f"test's)")
            + f" the uninterrupted run's step-{2 * TRAIN_RESUME_AT} "
            f"checkpoint ({len(diffs)} leaves)")
        out.update(resume_s=resume_s, resume_max_abs=resume_max,
                   resume_bit_identical=identical)
        del model, state, want

    # card = CPU for SmolLM, then every other family
    gen = torch.Generator(device=card).manual_seed(TRAIN_SEED)
    model = build_model(cfg, device=card).init(gen)
    chk = _train_batch(cfg, 2, CHECK_SEQ, card)
    loss_rel, worst, layers = _card_vs_cpu(TRAIN_ARCH, model, cfg, chk)
    out["card_cpu"] = {"loss_rel": loss_rel, "grad_rel": worst,
                       "layers": layers}
    log(f"[train] {cfg.name}: one backward at {layers} layers, f32: card vs "
        f"CPU loss {loss_rel:.3g} (rel, tol {TRAIN_LOSS_REL}), gradients "
        f"{worst:.3g} of a leaf's largest (tol {TRAIN_GRAD_REL})")
    del model, chk
    out["families"] = [_train_family(arch, cut, B, S, smi)
                       for arch, cut, B, S in TRAIN_MODELS]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[train] phase wall {out['wall_s']:.1f} s")
    return out


def _train_batch(cfg, B, text, device):
    """``B`` rows of the synthetic pipeline's step 0 with ``text`` token
    positions (a VLM row adds its patch positions)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    seq = text + (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    data = SyntheticTokens(cfg, ShapeSpec("train", seq, B, "train"),
                           DataConfig(seed=TRAIN_SEED,
                                      vocab_size=min(cfg.vocab_size, 512)),
                           device=device)
    return data.batch_at(0)


def _train_family(arch, cut, B, S, smi):
    """One config of TRAIN_MODELS: TRAIN_FAMILY_STEPS synchronised train
    steps through make_train_step, then the card = CPU backward; all it
    allocates on the card is freed when it returns."""
    from repro_torch.configs.base import load_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree_util import tree_leaves

    card = torch.device("cuda:0")
    t_family = time.perf_counter()
    full = load_config(arch)
    cfg = full.replace(**cut)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    meta = build_model(cfg, device="meta")
    sizes = [p.numel() * p.element_size() for p in meta.parameters()]
    estimate = 4 * sum(sizes) + 4 * max(sizes)
    if estimate > TRAIN_PEAK_LIMIT:
        layers = cfg.num_layers - 1
        log(f"[train] {full.name}: {cfg.num_layers} layers would need "
            f"~{estimate / 2**30:.1f} GiB (weights, gradients, AdamW moments "
            f"and the update's temporaries): cut to {layers}")
        cfg = cfg.replace(num_layers=layers)
        cut = dict(cut, num_layers=layers)
    gen = torch.Generator(device=card).manual_seed(TRAIN_SEED)
    model = build_model(cfg, device=card).init(gen)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    state = adamw.init_state(model)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((state.mu, state.nu)))
    step_fn = make_train_step(model, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=TRAIN_FAMILY_STEPS))
    batch = _train_batch(cfg, B, S, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, gnorms = [], [], []
    for _ in range(TRAIN_FAMILY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step_fn(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
            f"{arch}: loss {losses}, gnorm {gnorms}")
    positions = batch["tokens"].shape[1] + (
        cfg.num_patch_tokens if cfg.family == "vlm" else 0)
    del state, step_fn, metrics
    torch.cuda.empty_cache()
    chk = _train_batch(cfg, 2, CHECK_SEQ, card)
    t_check = time.perf_counter()
    loss_rel, worst, layers = _card_vs_cpu(arch, model, cfg, chk)
    check_s = time.perf_counter() - t_check
    wall_s = time.perf_counter() - t_family
    cuts = ", ".join(f"{k} {v} of {getattr(full, k)}" for k, v in cut.items())
    frames = (f", {cfg.num_audio_frames} audio frames"
              if cfg.family == "encdec" else "")
    log(f"[train] {full.name} ({cfg.family}, {cuts}, d_model {cfg.d_model}"
        f"{frames}, f32 weights and AdamW state, bf16 compute, remat "
        f"{cfg.remat}): {TRAIN_FAMILY_STEPS} steps of {B} x {positions} "
        f"positions, {times[-1] * 1e3:.1f} ms the last (first "
        f"{times[0] * 1e3:.1f}), loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"gnorm {gnorms}, max_memory_allocated {peak / 2**30:.2f} GiB over "
        f"{(weights + state_bytes) / 2**30:.2f} GiB of weights "
        f"({weights / 2**30:.2f}) and AdamW state; one backward at {layers} "
        f"layers, f32: card vs CPU loss {loss_rel:.3g} (rel), gradients "
        f"{worst:.3g} of a leaf's largest, in {check_s:.1f} s of the "
        f"config's {wall_s:.1f} s ({smi})")
    return {"arch": arch, "wall_s": wall_s, "check_s": check_s, "name": full.name, "family": cfg.family,
            "cut": cut, "batch": B, "positions": positions,
            "step_ms": [1e3 * t for t in times], "losses": losses,
            "grad_norms": gnorms, "peak_bytes": peak, "weight_bytes": weights,
            "adamw_state_bytes": state_bytes, "bytes_before": before,
            "card_cpu": {"loss_rel": loss_rel, "grad_rel": worst,
                         "layers": layers}, "card": smi}


# -------------------------------------------------------------------- mesh
# The mesh on one card: a one-rank NCCL group (make_host_mesh(1, 1)), so
# every parameter is a DTensor and every region runs its collectives over
# one rank.  N > 1 is exercised by the CPU tests only (gloo ranks,
# tests/test_torch_mesh_*.py): the card's host has one H100.
MESH_STEPS, MESH_CKPT_AT = 5, 3
MESH_TIMED_STEPS = 3      # synchronised sharded steps, their median reported
MESH_MOE = ("phi3_5_moe_42b", {"num_layers": 2}, 2, 256)
MESH_PIPE = (8, 4, 960)   # layers, microbatches, width (SmolLM's d_model)
MESH_PSUM_ELEMS = 1 << 22
MESH_DECODE_TOL = 1e-4    # tests/test_torch_mesh_collectives.py's bound
MESH_VP_TOL = 1e-4        # tests/test_torch_mesh_moe.py's bound
MESH_PIPE_TOL = 1e-5      # tests/test_torch_mesh_collectives.py's bound


def _local_twin(model):
    """The unsharded model over a one-rank mesh model's own storage (each
    DTensor's local tensor is the whole tensor)."""
    from repro_torch.models.model import build_model
    twin = build_model(model.cfg, device="meta")
    twin.load_state_dict({n: p.to_local() for n, p in
                          model.named_parameters()}, strict=True,
                         assign=True)
    return twin


def _max_rel(got: dict, want: dict):
    """The worst leaf's max |got - want| over its max |want|, and which."""
    return max((float((got[k].to_local() if hasattr(got[k], "to_local")
                       else got[k]).sub(want[k]).abs().max()) /
                max(float(want[k].abs().max()), 1e-30), k) for k in want)


def phase_mesh(smi, training):
    """The mesh path on the card, through its entry points, on one NCCL
    rank (``make_host_mesh(1, 1)``): SmolLM-360M uncut trained sharded
    through ``launch.train.train(mesh=)`` (its losses against the
    unsharded [train] run's first steps, a checkpoint at step
    ``MESH_CKPT_AT`` and a resume bit-identical to the uninterrupted run,
    the sharded step's time and kernels beside the unsharded step's); the
    expert-parallel MoE against the local path (Phi-3.5-MoE at 2 layers,
    full width, loss and gradients); the vocab-parallel CE at SmolLM's
    vocabulary against the gather CE; ``psum_int8`` against
    ``roundtrip_int8``; ``pipeline_apply`` with one stage against the
    sequential stack; a sequence-sharded SmolLM decode step against the
    unsharded one.  The group is destroyed at the end."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import model as MF
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import P, distribute
    from repro_torch.optim import adamw, compression
    from repro_torch.train.pipeline import pipeline_apply, split_stages
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.tree_util import tree_leaves

    t_phase = time.perf_counter()
    card = torch.device("cuda:0")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1)
    probe = torch.ones(1, device=card)
    dist.all_reduce(probe)   # NCCL makes its communicator on first use
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    require(float(probe) == 1.0, "a one-rank all_reduce changed its input")
    log(f"[mesh] one-rank NCCL group and a (data=1, model=1) mesh on "
        f"{torch.cuda.get_device_name(0)}: {startup_s:.2f} s to the first "
        f"all_reduce (one H100: N > 1 runs only in the CPU tests, over gloo)")
    out = {"nccl_startup_s": startup_s, "card": smi}

    # SmolLM-360M uncut, sharded through the trainer's entry point
    cfg = load_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = adamw.AdamWConfig(**TRAIN_OPT)

    def run(steps, ckpt_dir, lines):
        return train(cfg, shape, steps=steps, opt_cfg=opt, mesh=mesh,
                     ckpt_dir=ckpt_dir, ckpt_interval=MESH_CKPT_AT,
                     log_every=1, log_fn=lines.append, seed=TRAIN_SEED,
                     device=card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        t0 = time.perf_counter()
        model, state, losses = run(MESH_STEPS, None, [])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        want = [l for _, l in training["losses"][:MESH_STEPS]]
        got = [l for _, l in losses]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        require(len(got) == MESH_STEPS and loss_rel <= TRAIN_LOSS_REL,
                f"sharded losses {got} against unsharded {want}")
        require(all(isinstance(p, torch.distributed.tensor.DTensor)
                    for p in tree_leaves((model, state))),
                "a parameter or moment is not a DTensor")
        log(f"[mesh] {cfg.name} uncut through launch.train.train(mesh=): "
            f"{MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
            f"{run_s:.1f} s (init and the first step's DTensor sharding "
            f"propagation included); losses {[round(l, 4) for l in got]}, "
            f"the unsharded [train] run's first {MESH_STEPS} "
            + ("bit-identical" if got == want else
               f"within {loss_rel:.3g} (rel, tol {TRAIN_LOSS_REL})"))
        # a checkpoint at step MESH_CKPT_AT, then a run resumed from it
        ckpt_dir = Path(tmp) / "ckpt"
        t0 = time.perf_counter()
        m_a, s_a, l_a = run(MESH_CKPT_AT, ckpt_dir, [])
        require([l for _, l in l_a] == got[:MESH_CKPT_AT],
                f"a second sharded run's losses {l_a} differ from {got}")
        del m_a, s_a
        save_s = time.perf_counter() - t0
        lines = []
        t0 = time.perf_counter()
        m_b, s_b, l_b = run(MESH_STEPS, ckpt_dir, lines)
        resume_s = time.perf_counter() - t0
        require(lines and lines[0] == f"[train] resumed from step "
                f"{MESH_CKPT_AT}", f"the run did not resume: {lines[:1]}")
        pairs = list(zip(tree_leaves((model, state)),
                         tree_leaves((m_b, s_b))))
        identical = all(torch.equal(a.to_local(), b.to_local())
                        for a, b in pairs)
        worst = max(float((a.to_local().float() - b.to_local().float())
                          .abs().max()) for a, b in pairs)
        require(identical, f"the resumed sharded run differs from the "
                f"uninterrupted one by {worst:.3g}")
        require([l for _, l in l_b] == got[MESH_CKPT_AT:],
                f"resumed losses {l_b} against {got[MESH_CKPT_AT:]}")
        log(f"[mesh] {cfg.name}: {MESH_CKPT_AT} sharded steps and their "
            f"checkpoint (gathered leaves, rank 0 writes, barrier) in "
            f"{save_s:.1f} s; resumed at step {MESH_CKPT_AT} to "
            f"{MESH_STEPS} in {resume_s:.1f} s (restore, steps, the last "
            f"save): params and AdamW state bit-identical to the "
            f"uninterrupted sharded run ({len(pairs)} leaves)")
        del m_b, s_b

    # the sharded step's time and kernels beside the unsharded step's
    step_fn = make_train_step(model, opt)
    data = MF.input_pspecs(cfg, shape, model.axes)
    pipe = SyntheticTokens(cfg, shape, DataConfig(
        seed=TRAIN_SEED, vocab_size=min(cfg.vocab_size, 512)), device=card)

    def batch_at(i):
        return {k: distribute(v, mesh, data[k], src_data_rank=None)
                for k, v in pipe.batch_at(MESH_STEPS + i).items()}

    times = []
    for i in range(MESH_TIMED_STEPS):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step_fn(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = 1e3 * _median(times)
    batches = [batch_at(MESH_TIMED_STEPS + i)
               for i in range(PROFILED_TRAIN_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            _, state, metrics = step_fn(model, state, batch)
        torch.cuda.synchronize()
    busy_s, kernels = _device_busy(prof)
    require(bool(torch.isfinite(metrics["loss"].to_local())),
            "a timed sharded step's loss is not finite")
    kernels = None if kernels is None else kernels / PROFILED_TRAIN_STEPS
    busy = (None if busy_s is None else
            busy_s / (PROFILED_TRAIN_STEPS * step_ms / 1e3))
    plain_k = training.get("kernels_per_step")
    log(f"[mesh] {cfg.name}: {step_ms:.1f} ms a sharded train step (median "
        f"of {MESH_TIMED_STEPS} synchronised, {min(times) * 1e3:.1f}-"
        f"{max(times) * 1e3:.1f}) against {training['step_ms']:.1f} ms "
        f"unsharded in [train] ({step_ms / training['step_ms']:.2f}x: "
        f"DTensor's dispatch on every op); "
        + ("no device time recorded" if kernels is None else
           f"{kernels:.0f} kernels a step (unsharded "
           f"{plain_k if plain_k is None else round(plain_k)}), device busy "
           f"{100 * busy:.1f}% of a step") + f" ({smi})")
    out.update(arch=TRAIN_ARCH, steps=MESH_STEPS, losses=got,
               loss_max_rel=loss_rel, losses_bit_identical=got == want,
               run_s=run_s, save_s=save_s, resume_s=resume_s,
               resume_bit_identical=identical, step_ms=step_ms,
               step_runs_ms=[1e3 * t for t in times],
               unsharded_step_ms=training["step_ms"],
               kernels_per_step=kernels, unsharded_kernels_per_step=plain_k,
               device_busy_share=busy)
    del step_fn, metrics, batches, prof

    # a sequence-sharded decode step against the unsharded one (f32)
    f32 = cfg.replace(compute_dtype=torch.float32)
    axes = MF.make_axes(mesh, kv_partition="seq")
    dec = MF.build_model(f32, axes, mesh, device="meta")
    dec.load_state_dict({n: p for n, p in model.named_parameters()},
                        strict=True, assign=True)
    plain = _local_twin(dec)
    gen = torch.Generator(device=card).manual_seed(TRAIN_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=card)
    nxt = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH,), generator=gen,
                        device=card)
    with torch.no_grad():
        _, st = plain.prefill({"tokens": tokens}, pad_to=TRAIN_SEQ + 8)
        want_logits, _ = plain.decode_step(st, nxt)
        got_logits, got_st = dec.decode_step(st, nxt)
    dec_err = float((got_logits.to_local() - want_logits).abs().max())
    require(dec_err <= MESH_DECODE_TOL * max(
        1.0, float(want_logits.abs().max())),
        f"sequence-sharded decode differs by {dec_err:.3g}")
    log(f"[mesh] {cfg.name}: a decode step with the KV cache sharded on its "
        f"sequence (kv_partition seq, flash-decoding region) against the "
        f"unsharded step, f32, {TRAIN_BATCH} x {TRAIN_SEQ} cached: max "
        f"|d logits| {dec_err:.3g} (tol {MESH_DECODE_TOL} x max(1, |logits|))")
    out["decode_max_abs"] = dec_err
    del dec, plain, st, got_st, want_logits, got_logits

    # the vocab-parallel CE at SmolLM's vocabulary against the gather CE
    vp_cfg = f32.replace(ce_impl="vocab_parallel",
                         embed_sharding="model_only")
    h = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=gen,
                    device=card)
    table = (0.02 * torch.randn(cfg.vocab_padded, cfg.d_model,
                                generator=gen, device=card))
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=card)
    labels[:, :4] = -1      # unlabelled positions
    ce = {}
    for c in (f32, vp_cfg):
        ax = MF.make_axes(mesh)
        hd = distribute(h, mesh, P(ax.bspec, None, None)).requires_grad_()
        td = distribute(table, mesh, MF.param_pspecs({"embed": table},
                                                     c)["embed"])
        td.requires_grad_()
        ld = distribute(labels, mesh, P(ax.bspec, None))
        loss = T.chunked_ce_loss(hd, td, ld, c, ax, mesh=mesh)
        gh, gt = torch.autograd.grad(loss, (hd, td))
        ce[c.ce_impl] = (float(loss.to_local()), gh.to_local(),
                         gt.to_local())
    (lg, ghg, gtg), (lv, ghv, gtv) = ce["gather"], ce["vocab_parallel"]
    vp_loss = abs(lv - lg)
    vp_grad, _ = _max_rel({"h": ghv, "embed": gtv}, {"h": ghg, "embed": gtg})
    require(vp_loss < MESH_VP_TOL and vp_grad < MESH_VP_TOL,
            f"vocab-parallel CE off the gather CE by {vp_loss:.3g} (loss), "
            f"{vp_grad:.3g} (gradients)")
    log(f"[mesh] vocab-parallel CE at {cfg.vocab_padded} entries, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, f32: loss {lv:.6f} against the gather "
        f"CE's {lg:.6f} (|d| {vp_loss:.3g}), gradients {vp_grad:.3g} of a "
        f"leaf's largest (tol {MESH_VP_TOL})")
    out["vp_ce"] = {"loss_abs": vp_loss, "grad_rel": vp_grad}
    del model, state, h, table, ce, ghg, gtg, ghv, gtv

    # psum_int8 over one rank is the int8 round trip
    x = torch.randn(MESH_PSUM_ELEMS, generator=gen, device=card)
    with set_mesh(mesh):
        summed = compression.psum_int8(x, "data")
    require(torch.equal(summed, compression.roundtrip_int8(x)),
            "psum_int8 over one rank differs from roundtrip_int8")
    log(f"[mesh] psum_int8 of {MESH_PSUM_ELEMS} f32 values over a one-rank "
        f"axis: bit-identical to roundtrip_int8")

    # the GPipe pipeline with one stage against the sequential stack
    n_layers, n_micro, width = MESH_PIPE
    layers = {"w": torch.randn(n_layers, width, width, generator=gen,
                               device=card) * width ** -0.5,
              "b": 0.1 * torch.randn(n_layers, width, generator=gen,
                                     device=card)}
    xs = torch.randn(n_micro, TRAIN_BATCH, width, generator=gen, device=card)

    def stack(params, x):
        for w, b in zip(params["w"].unbind(0), params["b"].unbind(0)):
            x = torch.tanh(x @ w + b)
        return x

    got_pipe = pipeline_apply(stack, split_stages(layers, 1), xs, mesh,
                              axis="data").to_local()
    want_pipe = torch.stack([stack(layers, x) for x in xs])
    pipe_err = float((got_pipe - want_pipe).abs().max())
    require(pipe_err <= MESH_PIPE_TOL, f"the one-stage pipeline differs by "
            f"{pipe_err:.3g}")
    log(f"[mesh] pipeline_apply, 1 stage x {n_layers} layers, {n_micro} "
        f"microbatches of {TRAIN_BATCH} x {width}: max |d| {pipe_err:.3g} "
        f"against the sequential stack (tol {MESH_PIPE_TOL})")
    out["psum_int8_bit_identical"] = True
    out["pipeline_max_abs"] = pipe_err
    del layers, xs, got_pipe, want_pipe, x, summed
    torch.cuda.empty_cache()

    # expert parallelism against the local path (Phi-3.5-MoE, full width)
    arch, cut, B, S = MESH_MOE
    mcfg = load_config(arch).replace(**cut)
    maxes = MF.axes_for(mcfg, ShapeSpec("t", S, B, "train"), mesh)
    moe = MF.build_model(mcfg, maxes, mesh, device=card).init(
        torch.Generator(device=card).manual_seed(TRAIN_SEED))
    local = _local_twin(moe)
    batch = _train_batch(mcfg, B, S, card)
    t0 = time.perf_counter()
    l_ep, g_ep = _loss_grads(moe, batch)
    ep_s = time.perf_counter() - t0
    g_ep = {k: v.to_local() for k, v in g_ep.items()}
    t0 = time.perf_counter()
    l_loc, g_loc = _loss_grads(local, batch)
    loc_s = time.perf_counter() - t0
    moe_loss = abs(l_ep - l_loc) / abs(l_loc)
    moe_grad, leaf = _max_rel(g_ep, g_loc)
    require(moe_loss <= TRAIN_LOSS_REL and moe_grad <= TRAIN_GRAD_REL,
            f"expert-parallel MoE off the local path: loss {moe_loss:.3g}, "
            f"gradients {moe_grad:.3g} ({leaf})")
    log(f"[mesh] {mcfg.name} ({cut['num_layers']} layers, full width, bf16 "
        f"compute) expert-parallel against local, {B} x {S}: loss "
        f"{l_ep:.6f} / {l_loc:.6f} (rel {moe_loss:.3g}), gradients "
        f"{moe_grad:.3g} of a leaf's largest; loss and backward "
        f"{ep_s:.1f} s sharded, {loc_s:.1f} s local")
    out["moe"] = {"arch": arch, "loss_rel": moe_loss, "grad_rel": moe_grad,
                  "sharded_s": ep_s, "local_s": loc_s}
    del moe, local, g_ep, g_loc, batch
    torch.cuda.empty_cache()

    dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase wall {out['wall_s']:.1f} s; the group destroyed")
    return out


# ----------------------------------------------------------------- dry run
# the production cells the [dryrun] child traces on fake CUDA tensors, in
# the memory variant (train_microbatches): (arch, shape, multi-pod)
DRYRUN_CELLS = (("smollm_360m", "train_4k", False),
                ("smollm_360m", "prefill_32k", False),
                ("smollm_360m", "decode_32k", False),
                ("phi3_5_moe_42b", "decode_32k", False),
                ("smollm_360m", "decode_32k", True))
# the dry run's peak over the real step's (the one-card check), and the
# measured step over its roofline bound, each a required range
DRYRUN_PEAK_RATIO = (0.8, 1.25)
DRYRUN_TIMED_STEPS = 3
DRYRUN_CHILD_TIMEOUT = 900

# the child: no jax, no repro; one fake group a cell (run_cell starts and
# destroys it), then a one-rank fake group for the one-card cell; its
# result on the last line of its stdout
DRYRUN_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
from pathlib import Path
import torch.distributed as dist
from repro_torch.analysis.roofline import roofline
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import run_cell, start_fake_group
from repro_torch.launch.mesh import make_host_mesh
out_dir, device = Path(sys.argv[1]), sys.argv[2]
cells, (arch, seq, batch) = json.loads(sys.argv[3]), json.loads(sys.argv[4])
res = {"cells": []}
for a, shape, multi in cells:
    rec = run_cell(a, shape, multi, "memory", out_dir, device_type=device)
    rec.pop("traceback", None)
    rec["roofline"] = roofline(rec, 512 if multi else 256)
    res["cells"].append(rec)
start_fake_group(1)
mesh = make_host_mesh(1, 1, device_type=device)
rec = run_cell(arch, ShapeSpec("train", seq, batch, "train"), False, "cost",
               out_dir, tag="card_1x1", device_type=device, mesh=mesh)
dist.destroy_process_group()
rec.pop("traceback", None)
res["card"] = rec
res["wall_s"] = time.perf_counter() - t0
print(json.dumps(res))
"""


def start_dryrun(device="cuda"):
    """Start the ``[dryrun]`` child (host work only: fake tensors, no
    device memory) so that it runs beside the card's phases; returns the
    process and its directory.  The process is killed when this one
    exits."""
    import atexit
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    with open(tmp / "stdout", "w") as out, open(tmp / "stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, str(tmp / "records"),
             device, json.dumps(DRYRUN_CELLS),
             json.dumps([TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH])],
            cwd=tmp, env=env, stdout=out, stderr=err)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    atexit.register(shutil.rmtree, tmp, True)
    return proc, tmp, time.perf_counter()


def _gb(n):
    return n / 1e9


def _dryrun_cell_line(rec):
    ma, ca, rf = (rec["memory_analysis"], rec["cost_analysis"],
                  rec["roofline"])
    args, temp = ma["argument_size_in_bytes"], ma["temp_size_in_bytes"]
    coll = rec["collectives"]
    return (f"[dryrun] {rec['arch']} {rec['shape']} on the "
            f"{'(2, 16, 16)' if rec['mesh'] == 'multi' else '(16, 16)'} "
            f"mesh, memory variant: ok, traced in {rec['lower_s']:.1f} s; "
            f"a device: args {_gb(args):.3f} GB, temp {_gb(temp):.3f} GB, "
            f"peak {_gb(args + temp):.3f} GB "
            f"({'fits' if args + temp < H100_SXM['hbm_bytes'] else 'does NOT fit'} "
            f"{_gb(H100_SXM['hbm_bytes']):.0f} GB); collectives "
            f"{dict(sorted(coll['count'].items()))}, "
            f"{_gb(coll['total_wire_bytes']):.4f} GB on the wire "
            f"({_gb(rec['collective_links']['nvlink']):.4f} NVLink, "
            f"{_gb(rec['collective_links']['ib']):.4f} IB); "
            f"{ca['flops']:.4g} FLOPs; roofline compute "
            f"{rf['compute_s'] * 1e3:.3f} ms, memory "
            f"{rf['memory_s'] * 1e3:.3f} ms, collective "
            f"{rf['collective_s'] * 1e3:.3f} ms ({rf['dominant']})")


def _dryrun_real_step(device):
    """The one-card cell for real: SmolLM-360M uncut, one
    ``make_train_step`` step (one microbatch, as ``[train]``) of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` on a 1 x 1 mesh; returns its argument
    bytes (counted as the dry run counts them: ``local_bytes``), its peak
    (the growth of ``max_memory_allocated`` over the step, plus those
    arguments), FLOPs (``FlopCounterMode``) and the median step time."""
    import gc

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec, load_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MF
    from repro_torch.models.sharding import distribute
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step

    on_card = torch.device(device).type == "cuda"
    cfg = load_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mesh = make_host_mesh(1, 1, device_type=torch.device(device).type)
    axes = MF.axes_for(cfg, shape, mesh)
    model = MF.build_model(cfg, axes, mesh, device=device).init(
        torch.Generator(device=device).manual_seed(TRAIN_SEED))
    opt = adamw.init_state(model)
    step = make_train_step(model, adamw.AdamWConfig(**TRAIN_OPT), 1)
    data = SyntheticTokens(cfg, shape, DataConfig(seed=TRAIN_SEED),
                           device=device)
    specs = MF.input_pspecs(cfg, shape, axes)

    def batch(i):
        return {k: distribute(v, mesh, specs[k], what=k)
                for k, v in data.batch_at(i).items()}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    step(model, opt, batch(0))   # warm: sharding propagation, cuBLAS
    b = batch(1)
    args = local_bytes([model, opt, b])
    gc.collect()
    sync()
    if on_card:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    step(model, opt, b)
    sync()
    peak = (torch.cuda.max_memory_allocated() - base + args if on_card
            else None)
    with FlopCounterMode(display=False) as fc:
        step(model, opt, batch(2))
    sync()
    times = []
    for i in range(DRYRUN_TIMED_STEPS):
        b = batch(3 + i)
        sync()
        t0 = time.perf_counter()
        step(model, opt, b)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    del model, opt, step, b
    dist.destroy_process_group()
    return {"args": args, "peak": peak, "flops": fc.get_total_flops(),
            "ms": sorted(times)[len(times) // 2], "ms_all": times}


def phase_dryrun(smi, started):
    """``[dryrun]``: the child started by :func:`start_dryrun` (no jax, no
    ``repro``) dry-runs ``DRYRUN_CELLS`` on fake CUDA tensors over the
    256- and 512-rank production meshes of a ``fake`` group (this card's
    torch, whose DTensor rules are older than the CPU tests'), and the
    one-card cell, SmolLM-360M uncut training at ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` on a 1 x 1 mesh.  Every cell must run.  Then the same
    step runs for real on a one-rank NCCL mesh: the dry run's FLOPs must
    equal ``FlopCounterMode``'s on the real step, its per-device peak
    (arguments + temp) must be within ``DRYRUN_PEAK_RATIO`` of the real
    step's (``max_memory_allocated`` above what was allocated before the
    step, plus the step's arguments), and the measured step must take at
    least the roofline's compute term."""
    proc, tmp, t_start = started
    try:
        proc.wait(timeout=DRYRUN_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise SystemExit(f"chip_smoke: the [dryrun] child ran past "
                         f"{DRYRUN_CHILD_TIMEOUT} s")
    waited_s = time.perf_counter() - t_start
    stdout = (tmp / "stdout").read_text()
    if proc.returncode != 0:
        log(stdout[-4000:])
        log((tmp / "stderr").read_text()[-4000:])
    require(proc.returncode == 0, f"the [dryrun] child exited "
            f"{proc.returncode}")
    res = json.loads(stdout.strip().splitlines()[-1])
    out = {"card": smi, "child_s": res["wall_s"], "cells": []}
    for rec in res["cells"]:
        if not rec["ok"]:
            log(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: "
                f"FAILED on torch {torch.__version__}: {rec['error']}")
        require(rec["ok"], f"the dry run of {rec['arch']} {rec['shape']} "
                f"({rec['mesh']}) failed: {rec.get('error')}")
        log(_dryrun_cell_line(rec) + f"; {smi}")
        out["cells"].append({k: rec[k] for k in (
            "arch", "shape", "mesh", "variant", "lower_s",
            "memory_analysis", "cost_analysis", "collectives",
            "collective_links", "roofline")})

    card = res["card"]
    require(card["ok"], f"the one-card dry run failed: {card.get('error')}")
    ma, ca = card["memory_analysis"], card["cost_analysis"]
    dry_peak = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    compute_ms = ca["flops"] / H100_SXM["peak_bf16_flops"] * 1e3
    memory_ms = ca["bytes accessed"] / H100_SXM["hbm_bw"] * 1e3
    coll_wire = card["collectives"]["total_wire_bytes"]
    t0 = time.perf_counter()
    real = _dryrun_real_step("cuda")
    real_s = time.perf_counter() - t0
    ratio = dry_peak / real["peak"]
    log(f"[dryrun] one card, {TRAIN_ARCH} uncut, one train step of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} on a 1 x 1 mesh: dry run (fake CUDA "
        f"tensors, traced in {card['lower_s']:.1f} s) args "
        f"{_gb(ma['argument_size_in_bytes']):.4f} GB + temp "
        f"{_gb(ma['temp_size_in_bytes']):.4f} GB = peak {_gb(dry_peak):.4f} "
        f"GB; the real step's args {_gb(real['args']):.4f} GB, peak "
        f"{_gb(real['peak']):.4f} GB (max_memory_allocated above the "
        f"step's start, plus its arguments): ratio {ratio:.4f}; FLOPs dry "
        f"{ca['flops']:.6g}, FlopCounterMode on the real step "
        f"{real['flops']:.6g}; {smi}")
    log(f"[dryrun] the real step {real['ms']:.1f} ms (median of "
        f"{DRYRUN_TIMED_STEPS}: {[round(t, 1) for t in real['ms_all']]}) "
        f"against the roofline's terms: compute {compute_ms:.3f} ms, "
        f"memory {memory_ms:.3f} ms (unfused bytes accessed "
        f"{_gb(ca['bytes accessed']):.2f} GB), collective 0 ms "
        f"({coll_wire:.0f} wire bytes on one rank): "
        f"{real['ms'] / max(compute_ms, memory_ms):.2f}x the bound; "
        f"real part {real_s:.1f} s; the child {res['wall_s']:.1f} s, "
        f"beside the other phases ({waited_s:.1f} s from its start to "
        f"here); {smi}")
    require(ca["flops"] == real["flops"], f"the dry run's FLOPs "
            f"{ca['flops']} differ from FlopCounterMode's {real['flops']}")
    require(ma["argument_size_in_bytes"] == real["args"], f"the dry run's "
            f"argument bytes {ma['argument_size_in_bytes']} differ from the "
            f"real step's {real['args']}")
    lo, hi = DRYRUN_PEAK_RATIO
    require(lo <= ratio <= hi, f"the dry run's peak is {ratio:.3f}x the "
            f"real step's (range {DRYRUN_PEAK_RATIO})")
    require(real["ms"] >= compute_ms, f"the step ({real['ms']:.3f} ms) beat "
            f"its compute bound ({compute_ms:.3f} ms)")
    require(coll_wire == 0, "a one-rank step sent bytes")
    out["one_card"] = {
        "dry": {"args": ma["argument_size_in_bytes"],
                "temp": ma["temp_size_in_bytes"], "peak": dry_peak,
                "flops": ca["flops"], "bytes_accessed": ca["bytes accessed"],
                "lower_s": card["lower_s"]},
        "real": real, "peak_ratio": ratio, "compute_ms": compute_ms,
        "memory_ms": memory_ms}
    return out


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
           ("zamba2_2_7b", 2, 4096, *z, f32),
           ("mamba2_2_7b prefill", 1, 4096, *m, f32)]
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
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed("device", phase_device)
    dryrun = start_dryrun()
    timed("build", phase_build)
    card_tests = timed("card-tests", phase_card_tests)
    timed("kernel", phase_kernel_checks)
    machines, wall, launches, models = timed("main", phase_main_path)
    timing = timed("main-chunks", phase_main_chunks, machines, launches)
    lanes = timed("lanes", phase_lanes, models, wall, launches, timing, smi)
    timed("breakdown", phase_breakdown)
    serve_launches, served_waves, wide_args, serve = timed(
        "serve", phase_serve, models)
    serve_kernel = timed("serve-kernel", phase_serve_kernel, served_waves,
                         wide_args)
    scripts = timed("scripts", phase_scripts, models)
    corpus, corpus_trace = timed("corpus", phase_corpus)
    trace_report = timed("trace-report", phase_trace_report, corpus_trace,
                         corpus, smi)
    del corpus_trace
    errs = timed("blockers", phase_blockers)
    blocker_launches, profiles = timed("hardware", phase_hardware)
    blocker_times = timed("timing", phase_blocker_timing)
    ops_launches, ops_errs, ops_inputs, ssd_shares = timed("ops", phase_ops)
    ops_times = timed("ops-timing", phase_ops_timing, ops_inputs)
    del ops_inputs
    model_serving = timed("models", phase_models, smi)
    training = timed("train", phase_train, smi)
    meshed = timed("mesh", phase_mesh, smi, training)
    dry = timed("dryrun", phase_dryrun, smi, dryrun)
    log(f"[walls] seconds a phase ({smi}): {json.dumps(walls)}")
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
        "campaign_wall_s": wall,
        "corpus_launches": corpus["launches"]["wave_dispatch"],
        "corpus_widest": corpus["widest_wave_dispatch"],
        "lanes": dict(lanes, corpus=corpus["lanes"])}]}
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
        "served_waves": len(served_waves), **serve,
        "corpus_launches": corpus["launches"]["port_bound"],
        "corpus_widest": corpus["widest_port_bound"]})
    report["corpus"] = {k: v for k, v in corpus.items()
                        if not k.startswith("widest_")}
    # the port bound's launch mix, for port_bound_ablation.py --mix
    from repro_torch.kernels._build import build_dir
    mix = build_dir() / "port_bound_launches.json"
    mix.parent.mkdir(parents=True, exist_ok=True)
    mix.write_text(json.dumps({
        "serve": serve_kernel["launches_BCS"],
        "corpus": corpus["port_bound_launches_BCS"]}))
    log(f"[serve-kernel] the port bound's launch mix ({len(served_waves)} "
        f"served, {len(corpus['port_bound_launches_BCS'])} corpus "
        f"launches, (B, C, S) each) written to {mix}")
    report["scripts"] = scripts
    report["trace_report"] = trace_report
    report["models"] = model_serving
    report["train"] = training
    report["mesh"] = meshed
    report["dryrun"] = dry
    report["phase_s"] = walls
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
