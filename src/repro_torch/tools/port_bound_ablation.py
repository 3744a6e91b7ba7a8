"""Same-call ablation of the port-bound kernel's design on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.tools.port_bound_ablation \\
        [--rounds 2] [--reps 200] [--baseline FILE] [--mix FILE] \\
        [--out FILE]

Builds ``src/repro_torch/csrc/port_bound.cu`` as it is ("kept") and
variants that each differ from it in one part of the design, made from
its text by exact replacement (the script stops if a replaced text is no
longer there):

* ``group 8`` / ``group 32``: a fixed group of lanes a row at every B
  (kept: the widest of 32, 16, 8, 4 that runs a CTA's share of rows in
  one pass);
* ``slots 8``: a row's nonzero counts held in registers (``kSlots``,
  kept 4);
* ``a warp a CTA``: CTAs of a single warp when a wave has fewer rows than
  there are CTAs in a round (``kMinThreads 32``; kept 256);
* ``cand 1`` / ``cand 4``: a fixed count of candidates a lane holds at
  once (kept: the one of 1 to 4 that pads the mask's rows the least);
* ``bit sets``: the mask also as one 32-bit set a candidate (one ballot
  a candidate over the int mask in shared memory, on a CTA's first
  tile), beside its size, and each demand masked adds in place of a load
  and a multiply-add a nonzero count;
* ``256 threads``: CTAs of at most 256 threads, not 512
  (``kMaxThreads``);
* ``one CTA an SM``: ``kCtasPerSm 1`` (kept 2), twice the rows a CTA
  past 16 rows an SM;
* ``two CTAs an SM``: a round of ``kCtasPerSm`` CTAs an SM at every B
  (kept: one an SM while a CTA's share runs at 32 lanes a row);
* ``slot branches``: a row's register slots past its nonzero count are
  skipped by a branch (kept: summed, adding 0);
* ``a warp a mask row``: each warp copies whole rows of the mask (kept:
  the mask as one run, spread over the CTA's threads);
* ``a CTA a pass``: not persistent, a CTA for each pass of at most 512
  threads' rows, each loading the table;
* ``plain copies``: u tiles and the table copied by loads and stores, not
  ``cp.async``.

``--baseline FILE`` adds another ``port_bound.cu`` whose entry point
writes two outputs, ``port_bound_launch(u, mask, size, num, den, rows, C,
S, stream)``, timed in the same turns.  ``--mix FILE`` (the JSON that
``chip_smoke.py`` writes to ``build/repro_torch/port_bound_launches.json``:
the (B, C, S) of every port-bound launch of its serve and corpus phases)
adds, for each build, the device ms of each group's launches summed, each
launch on served rows of its (C, S), cycled past the wave's rows.

Inputs are served ones: the three simulated uarches' models from a
``Campaign`` over ``TEST_ISA`` on the card, and for each distinct (C, S)
the first B rows of a 10,000-block wave (seed 1234, as ``chip_smoke.py``'s
widest wave) packed as the ``cuda`` predict backend packs them, for B in
32, 256, 1,024, 2,048 and 9,936 (up to the wave's rows).  Every build's
quotients must equal ``port_bound_ref``'s bit for bit (the script stops
otherwise); then device ms a launch, ``--reps`` launches back to back
behind a spin.  Builds run in turns, kept first, the variants, the
variants reversed, kept last, ``--rounds`` times.  Prints a line a build
and round, the card's name and power limit, and writes the readings as
JSON to ``--out``.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import port_bound as pb
from repro_torch.kernels._build import CudaLibrary, build_dir

KEPT = Path(pb.__file__).resolve().parents[1] / "csrc" / "port_bound.cu"
ROWS = (32, 256, 1024, 2048, 9936)
WAVE_BLOCKS, WAVE_SEED = 10_000, 1234
_GROUP = ("  int g = 32;\n"
          "  while (g > 4 && share * g > kMaxThreads) g /= 2;\n")
_CAND = "  for (int k = 4; k >= 1; --k) {\n"

# ------------------------------------------------------ the bit-set variant
BIT_SETS = [
    ("  int* const mask_s = size_s + Sp;        // then the mask\n",
     "  int* const mask_s = size_s + Sp;        // then the mask,\n"
     "  int2* const pairs =                     // then (set, size) pairs\n"
     "      reinterpret_cast<int2*>(size_s + ((a.C * Sp + Sp + 1) & ~1));\n"),
    ("    copy_wait_older();\n    __syncthreads();\n",
     "    copy_wait_older();\n    __syncthreads();\n"
     "    if (kRowBits && it == 0) {  // lane c of a warp reads mask[c, s]\n"
     "      const int lane = threadIdx.x & 31;\n"
     "      for (int s = threadIdx.x >> 5; s < Sp; s += blockDim.x >> 5) {\n"
     "        const unsigned b = __ballot_sync(\n"
     "            kFullMask, lane < a.C && mask_s[lane * Sp + s] != 0);\n"
     "        if (lane == 0) pairs[s] = make_int2((int)b, size_s[s]);\n"
     "      }\n"
     "      __syncthreads();\n"
     "    }\n"),
    ("        int off[kSlots], us[kSlots];\n",
     "        unsigned bits[kSlots];\n        int off[kSlots], us[kSlots];\n"),
    ("          const unsigned bit = nz & (0u - nz);\n",
     "          const unsigned bit = bits[i] = nz & (0u - nz);\n"),
    ("          int d[K], bd[K];\n",
     "          int d[K], bd[K];\n          unsigned m[K];\n"),
    ("            bd[k] = size_s[s0 + G * k];\n",
     "            const int2 e = pairs[s0 + G * k];\n"
     "            m[k] = (unsigned)e.x;\n"
     "            bd[k] = e.y;\n"),
    ("            for (int k = 0; k < K; ++k) d[k] += col[G * k] * us[i];\n",
     "            for (int k = 0; k < K; ++k)\n"
     "              d[k] += (m[k] & bits[i]) ? us[i] : 0;\n"),
    ("  return ((size_t)a.C * a.Sp + a.Sp) * sizeof(int);\n",
     "  return ((((size_t)a.C * a.Sp + a.Sp + 1) & ~(size_t)1) +\n"
     "          2 * (size_t)a.Sp) * sizeof(int);\n"),
]

# ------------------------------------------------- the plain-copies variant
PLAIN_COPIES = [
    ('  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);\n'
     '  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d),\n'
     '               "l"(src)\n'
     '               : "memory");\n',
     '  *dst = __ldg(src);\n'),
    ('  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);\n'
     '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" '
     '::"r"(d),\n'
     '               "l"(src)\n'
     '               : "memory");\n',
     '  *reinterpret_cast<int4*>(dst) =\n'
     '      __ldg(reinterpret_cast<const int4*>(src));\n'),
    ('  asm volatile("cp.async.commit_group;\\n" ::: "memory");\n', ''),
    ('  asm volatile("cp.async.wait_group 1;\\n" ::: "memory");\n', ''),
]

# --------------------------------------------- the table copied a row a warp
TABLE_RUN = """\
  if (kTabSmem) {  // the mask as one run: a CTA's requests coalesce
    for (int s = threadIdx.x; s < a.S; s += blockDim.x)
      copy4(size_s + s, a.size + s);
    for (int i = threadIdx.x; i < a.C * a.S; i += blockDim.x) {
      const int c = i / a.S;
      copy4(mask_s + c * Sp + (i - c * a.S), a.mask + i);
    }
  }
"""
TABLE_ROWS = """\
  if (kTabSmem) {  // a warp a mask row
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int s = threadIdx.x; s < a.S; s += blockDim.x)
      copy4(size_s + s, a.size + s);
    for (int c = threadIdx.x >> 5; c < a.C; c += nw)
      for (int s = lane; s < a.S; s += 32)
        copy4(mask_s + c * Sp + s, a.mask + (long long)c * a.S + s);
  }
"""

VARIANTS = {
    "group 8": [(_GROUP, "  int g = 8;\n")],
    "group 32": [(_GROUP, "  int g = 32;\n")],
    "slots 8": [("constexpr int kSlots = 4;", "constexpr int kSlots = 8;")],
    "a warp a CTA": [("constexpr int kMinThreads = 256;",
                      "constexpr int kMinThreads = 32;")],
    "cand 1": [(_CAND, "  for (int k = 1; k >= 1; --k) {\n")],
    "cand 4": [(_CAND, "  for (int k = 4; k >= 4; --k) {\n")],
    "bit sets": BIT_SETS,
    "256 threads": [("constexpr int kMaxThreads = 512;",
                     "constexpr int kMaxThreads = 256;")],
    "one CTA an SM": [("constexpr int kCtasPerSm = 2;",
                       "constexpr int kCtasPerSm = 1;")],
    "two CTAs an SM": [
        ("  long long round = dev.sms;\n"
         "  if ((rows + round - 1) / round * 32 > kMaxThreads) "
         "round *= kCtasPerSm;\n",
         "  const long long round = (long long)dev.sms * kCtasPerSm;\n")],
    "slot branches": [
        ("            const int* col = mask_s + off[i] + s0;\n",
         "            if (i >= n) break;\n"
         "            const int* col = mask_s + off[i] + s0;\n")],
    "a warp a mask row": [(TABLE_RUN, TABLE_ROWS)],
    "a CTA a pass": [
        ("  a.tile_rows = want < cap ? want : cap;\n",
         "  a.tile_rows = pass;\n"),
        ("  const long long grid = a.tiles > round ? round : a.tiles;\n",
         "  const long long grid = a.tiles;\n")],
    "plain copies": PLAIN_COPIES,
}


def variant_source(kept, pairs):
    """``kept`` with each ``(old, new)`` of ``pairs`` replaced; ``old``
    must occur exactly once."""
    for old, new in pairs:
        if kept.count(old) != 1:
            raise SystemExit(f"port_bound_ablation: the text to replace is "
                             f"not in the source once: {old[:70]!r}")
        kept = kept.replace(old, new)
    return kept


def _bind_two_outputs(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.port_bound_launch.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.port_bound_launch.restype = ctypes.c_int


def _libraries(baseline):
    """The kept build, every variant and the baseline, built in parallel."""
    kept = KEPT.read_text()
    out = build_dir() / "port_bound_ablation"
    out.mkdir(parents=True, exist_ok=True)
    libs = {"kept": CudaLibrary(str(KEPT), pb._bind)}
    for name, pairs in VARIANTS.items():
        path = out / f"pb_{name.replace(' ', '_')}.cu"
        path.write_text(variant_source(kept, pairs))
        libs[name] = CudaLibrary(str(path), pb._bind)
    if baseline:
        path = out / "pb_baseline.cu"
        path.write_text(Path(baseline).read_text())
        libs["baseline"] = CudaLibrary(str(path), _bind_two_outputs)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()
    return libs


def _caller(name, lib):
    """A function of (u, mask, size) that launches ``lib``'s kernel and
    returns ``(num, den)``."""
    if name != "baseline":
        def call(u, mask, size):
            pb.LIBRARY = lib
            return pb.port_bound(u, mask, size)
        return call

    def call(u, mask, size):
        B, C = u.shape
        num = torch.empty(B, dtype=torch.int32, device=u.device)
        den = torch.empty(B, dtype=torch.int32, device=u.device)
        lib.launch("port_bound_launch", u.device, u.data_ptr(),
                   mask.data_ptr(), size.data_ptr(), num.data_ptr(),
                   den.data_ptr(), B, C, mask.shape[1])
        return num, den
    return call


def served_models():
    """The three simulated uarches' models, characterized on the card over
    ``TEST_ISA``."""
    from repro_torch.core.engine import Campaign
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.simulator import SimMachine
    from repro_torch.core.uarch import SIM_UARCHES
    return Campaign().run([SimMachine(ua, TEST_ISA, backend="cuda")
                           for ua in SIM_UARCHES.values()], TEST_ISA).models


def _served_inputs():
    """``{(C, S): (uarch, u, mask, size)}``: a 10,000-block wave of each
    uarch's model, packed by the ``cuda`` predict backend, the first uarch
    of each (C, S)."""
    from repro_torch.core.isa import TEST_ISA
    from repro_torch.core.predictor import sum_usage
    from repro_torch.service.batch_predictor import BatchPredictor
    from repro_torch.service.workload import random_blocks
    models = served_models()
    out = {}
    for ua in sorted(models):
        bp = BatchPredictor(models[ua], TEST_ISA, backend="cuda")
        blocks = random_blocks(models[ua], TEST_ISA, WAVE_BLOCKS,
                               seed=WAVE_SEED)
        bp.launched_args = []
        bp._port_bounds({i: sum_usage(bp.model, list(b))
                         for i, b in enumerate(blocks)})
        u, mask, size = bp.launched_args[0]
        out.setdefault(tuple(mask.shape), (ua, u, mask, size))
    return out


def _mixes(path, inputs):
    """``{group: [(count, args, want)]}`` for each distinct (B, C, S) of
    each group of ``path``: the first B rows of the served wave of that
    (C, S), cycled past its rows."""
    out = {}
    for group, shapes in json.loads(Path(path).read_text()).items():
        counts = Counter(tuple(bcs) for bcs in shapes)
        out[group] = []
        for (B, C, S), count in sorted(counts.items()):
            if (C, S) not in inputs:
                raise SystemExit(f"port_bound_ablation: no served wave of "
                                 f"(C, S) = ({C}, {S}) for the {group} mix")
            _, u, mask, size = inputs[(C, S)]
            rows = torch.arange(B, device=u.device) % len(u)
            args = (u[rows].contiguous(), mask, size)
            out[group].append((count, args,
                               _quotients(*pb.port_bound_ref(*args))))
    return out


def _quotients(num, den):
    return (num.cpu().double() / den.cpu().double()).numpy().view(np.int64)


def _device_ms(fn, args, reps):
    """Device ms a launch, ``reps`` launches queued behind a spin."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    if start.query():
        raise SystemExit("port_bound_ablation: the spin ended before the "
                         "launches were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--mix", default=None)
    ap.add_argument("--out",
                    default=str(build_dir() / "port_bound_ablation.json"))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("port_bound_ablation: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = _libraries(opt.baseline)
    inputs = _served_inputs()
    cases = []
    for (C, S), (ua, u, mask, size) in sorted(inputs.items()):
        for B in ROWS:
            if B <= len(u):
                args = (u[:B].contiguous(), mask, size)
                want = _quotients(*pb.port_bound_ref(*args))
                cases.append((f"{ua} B={B} C={C} S={S}", args, want))
    mixes = _mixes(opt.mix, inputs) if opt.mix else {}
    names = [n for n in libs if n != "kept"]
    order = ["kept", *names, *reversed(names), "kept"] * opt.rounds
    readings = {name: {} for name in libs}
    for name in order:
        call = _caller(name, libs[name])
        parts = []
        for case, args, want in cases:
            num, den = call(*args)
            torch.cuda.synchronize()
            if not np.array_equal(_quotients(num, den), want):
                raise SystemExit(f"port_bound_ablation: {name} differs from "
                                 f"port_bound_ref at {case}")
            ms = _device_ms(call, args, opt.reps)
            readings[name].setdefault(case, []).append(ms)
            parts.append(f"{case} {ms:.5f}")
        for group, launches in mixes.items():
            total = 0.0
            for count, args, want in launches:
                if not np.array_equal(_quotients(*call(*args)), want):
                    raise SystemExit(f"port_bound_ablation: {name} differs "
                                     f"from port_bound_ref in the {group} "
                                     f"mix")
                total += count * _device_ms(call, args, opt.reps)
            readings[name].setdefault(f"mix {group}", []).append(total)
            parts.append(f"mix {group} ({sum(c for c, _, _ in launches)} "
                         f"launches) {total:.5f} in all")
        print(f"[ablation] {name}: " + "; ".join(parts), flush=True)
    print(smi, flush=True)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text(json.dumps({"device": smi,
                                         "readings": readings}, indent=1))


if __name__ == "__main__":
    main()
