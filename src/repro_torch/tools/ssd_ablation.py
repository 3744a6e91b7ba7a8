"""Same-call ablation of the SSD scan's CUDA design on one NVIDIA GPU.

    PYTHONPATH=src python3 -m repro_torch.tools.ssd_ablation \\
        [--rounds 2] [--reps 10] [--out FILE]

Builds ``src/repro_torch/csrc/ssd_scan.cu`` as it is ("kept") and variants
that each differ from it in one part, made from its text by exact
replacement (the script stops if a replaced text is no longer there):

* ``scores per head``: ``ssd_chunk_cb`` is not launched; each head's
  ``ssd_chunk_scan`` computes its rows' scores C B^T itself, on the tensor
  cores, from a staged tile of B, in place of reading them once a group;
* ``two accumulators``: ``ssd_chunk_state`` sums the two small 3xTF32
  products and big * big into two accumulators, added at the end, not
  all three into one;
* ``no bf16 elision``: the product with the small part of an operand read
  from bf16 (exactly 0) is computed as for f32;
* ``8-tile state``: ``ssd_chunk_state``'s 8-tile instance for every N (N =
  64 too), not the 4-tile one below N = 64;
* ``tile branches``: every warp guards each n8 tile by a run-time bound
  (``if (tile * 8 >= P)``), as a kernel for any P and N would.

Every build runs the op layer's SSD cases at full width (Mamba2-2.7B f32
and bf16, Zamba2-2.7B f32, inputs from seed 0 as ``chip_smoke.py`` makes
them): its output is held against ``ssd_scan_ref`` at the stated
tolerance (1e-4 f32, 5e-2 bf16; a variant outside it is reported as no
ablation), then the whole call and each pass are timed, device ms a launch
with ``--reps`` launches back to back behind a spin.  Builds run in turns,
kept first, the variants, the variants reversed, kept last, ``--rounds``
times.  Prints a line a run, the card's name and power limit, and writes
the readings as JSON to ``--out``.
"""
import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import ssd_scan as sd
from repro_torch.kernels._build import CudaLibrary, build_dir

KEPT = Path(sd.__file__).resolve().parents[1] / "csrc" / "ssd_scan.cu"
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
CASES = [("mamba2_2_7b", (2, 4096, 80, 64, 128, 1, 256), torch.float32),
         ("mamba2_2_7b", (2, 4096, 80, 64, 128, 1, 256), torch.bfloat16),
         ("zamba2_2_7b", (2, 4096, 80, 64, 64, 1, 256), torch.float32)]

# ------------------------------------------ the two-accumulator variant
TWO_ACCUMULATORS = r'''// a * b in 3xTF32: cs += the small terms, cb += big*big
template <bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32_2(float cs[4], float cb[4],
                                             const uint32_t ab[4],
                                             const uint32_t as[4], float b0,
                                             float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(cs, as, bb0, bb1);
  if constexpr (!B_EXACT) mma_tf32(cs, ab, bs0, bs1);
  mma_tf32(cb, ab, bb0, bb1);
}

'''

# ---------------------------------------------------- the per-head variant
PER_HEAD_SCORES = r'''
// C B^T of a warp's 16 rows (C from global memory) against the 64 B rows
// of a staged tile, in the types stored
template <typename U>
struct HeadScores;
template <>
struct HeadScores<float> {
  static __device__ __forceinline__ void run(
      float acc[8][4], const float* c_lo, const float* c_hi, bool in_lo,
      bool in_hi, const float* b_tile, int ld, int N, int N16, int g, int t) {
    for (int k0 = 0; k0 < N16; k0 += 8) {
      const float2 lo = ld_pair(c_lo, k0 + 2 * t, N, in_lo, (N & 1) == 0);
      const float2 hi = ld_pair(c_hi, k0 + 2 * t, N, in_hi, (N & 1) == 0);
      const float av[4] = {lo.x, hi.x, lo.y, hi.y};
      uint32_t ab[4], as[4];
      split4(av, ab, as);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 bv = pair_f32(b_tile + (jn * 8 + g) * ld + k0 + 2 * t);
        mma_3xtf32<false, false>(acc[jn], ab, as, bv.x, bv.y);
      }
    }
  }
};
template <>
struct HeadScores<bf16> {
  static __device__ __forceinline__ void run(
      float acc[8][4], const bf16* c_lo, const bf16* c_hi, bool in_lo,
      bool in_hi, const bf16* b_tile, int ld, int N, int N16, int g, int t) {
    auto word = [](const bf16* p) {
      return *reinterpret_cast<const uint32_t*>(p);
    };
    auto at = [&](const bf16* row, bool in, int k) {
      return in && k < N ? word(row + k) : 0u;
    };
    for (int k0 = 0; k0 < N16; k0 += 16) {
      const uint32_t a[4] = {at(c_lo, in_lo, k0 + 2 * t),
                             at(c_hi, in_hi, k0 + 2 * t),
                             at(c_lo, in_lo, k0 + 8 + 2 * t),
                             at(c_hi, in_hi, k0 + 8 + 2 * t)};
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const bf16* br = b_tile + (jn * 8 + g) * ld + k0 + 2 * t;
        mma_bf16(acc[jn], a, word(br), word(br + 8));
      }
    }
  }
};

template <typename T, typename U>
__global__ void __launch_bounds__(SSD_TILE_THREADS)
ssd_chunk_scan('''

PER_HEAD_LOOP = r'''    cp_async_wait_prior();
    __syncthreads();
    const T* xt = ring + (jt & 1) * SSD_T * ldx;
    float sc[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[jn][q] = 0.f;
    HeadScores<U>::run(sc, c_lo, c_hi, in_lo, in_hi,
                       bring + (jt & 1) * SSD_T * ldb, ldb, N, N16, g, t);
#pragma unroll
    for (int kk = 0; kk < SSD_T / 8; ++kk) {
      if (kk >= steps) break;
      const int ja = jbase + kk * 8 + 2 * t, jb = ja + 1;
      const float2 sl = make_float2(sc[kk][0], sc[kk][1]);
      const float2 sh = make_float2(sc[kk][2], sc[kk][3]);
'''


def _per_head(src):
    return _swap(src, [
        ("\ntemplate <typename T, typename U>\n"
         "__global__ void __launch_bounds__(SSD_TILE_THREADS)\n"
         "ssd_chunk_scan(", PER_HEAD_SCORES),
        ("      (size_t)2 * SSD_T * (SSD_MAX_P + (xs == 4 ? 4 : 8)) * xs;\n",
         "      (size_t)2 * SSD_T * (SSD_MAX_P + (xs == 4 ? 4 : 8)) * xs +\n"
         "      (size_t)2 * SSD_T * pair_ld(N16) * sizeof(float);\n"),
        ("               const float* __restrict__ cb,\n"
         "               const float* __restrict__ states",
         "               const U* __restrict__ cb,\n"
         "               const float* __restrict__ states"),
        ("  const float* cbb = cb + (((size_t)b * G + grp) * nc + c) * "
         "(size_t)Q * Q;\n"
         "  const float* s_lo_row = cbb + (size_t)i_lo * Q;\n"
         "  const float* s_hi_row = s_lo_row + 8 * (size_t)Q;\n",
         "  const U* Bb = cb + ((size_t)b * S + c0) * brow + "
         "(size_t)grp * N;\n  const int ldb = pair_ld(N16);\n"
         "  const bool vec_b = vec_s && (N * sizeof(U)) % 16 == 0;\n"),
        ("  T* ring = reinterpret_cast<T*>(ss);  // 2 stages of SSD_T x ldx\n",
         "  T* ring = reinterpret_cast<T*>(ss);  // 2 stages of SSD_T x ldx\n"
         "  U* bring = reinterpret_cast<U*>(ring + 2 * SSD_T * "
         "col_ld<T>(SSD_MAX_P));\n"),
        ("              xrow, SSD_T, Q - j0, P, SSD_MAX_P, vec_x);\n  };",
         "              xrow, SSD_T, Q - j0, P, SSD_MAX_P, vec_x);\n"
         "    load_tile(bring + (jt & 1) * SSD_T * ldb, ldb, Bb + (size_t)j0 "
         "* brow,\n              brow, SSD_T, Q - j0, N, N16, vec_b);\n  };"),
        ("    float2 s_lo = ld_pair(s_lo_row, jbase + 2 * t, Q, in_lo, "
         "pairs_q);\n"
         "    float2 s_hi = ld_pair(s_hi_row, jbase + 2 * t, Q, in_hi, "
         "pairs_q);\n"
         "    cp_async_wait_prior();\n"
         "    __syncthreads();\n"
         "    const T* xt = ring + (jt & 1) * SSD_T * ldx;\n"
         "    for (int kk = 0; kk < steps; ++kk) {\n"
         "      const int ja = jbase + kk * 8 + 2 * t, jb = ja + 1;\n"
         "      const float2 sl = s_lo, sh = s_hi;\n"
         "      if (kk + 1 < steps) {\n"
         "        s_lo = ld_pair(s_lo_row, ja + 8, Q, in_lo, pairs_q);\n"
         "        s_hi = ld_pair(s_hi_row, ja + 8, Q, in_hi, pairs_q);\n"
         "      }\n", PER_HEAD_LOOP),
        ("        (const float*)cb, (const float*)states, (T*)y,",
         "        (const U*)cb, (const float*)states, (T*)y,"),
        ("  err = ssd_chunk_cb_launch(B, C, cb, b, S, G, N, Q, bc_dtype, "
         "stream);\n  if (err) return err;\n"
         "  return ssd_chunk_scan_launch(x, dt, C, cum, cb, states,",
         "  (void)cb;\n"
         "  return ssd_chunk_scan_launch(x, dt, C, cum, B, states,"),
    ])


VARIANTS = {
    "scores per head": _per_head,
    "two accumulators": lambda s: _swap(s, [
        ("// c += a * b in 3xTF32: the two small terms first, then big * big",
         TWO_ACCUMULATORS + "// c += a * b in 3xTF32: the two small "
         "terms first, then big * big"),
        ("  float acc[NT][4];\n#pragma unroll\n"
         "  for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
         "    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;",
         "  float acc[NT][4], acb[NT][4];\n#pragma unroll\n"
         "  for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
         "    for (int q = 0; q < 4; ++q) acc[nt][q] = acb[nt][q] = 0.f;"),
        ("          mma_3xtf32<false, sizeof(U) == 2>(\n"
         "              acc[nt], ab, as,",
         "          mma_3xtf32_2<sizeof(U) == 2>(\n"
         "              acc[nt], acb[nt], ab, as,"),
        ("  if (!rows_on) return;\n",
         "  if (!rows_on) return;\n#pragma unroll\n"
         "  for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n"
         "    for (int q = 0; q < 4; ++q) acc[nt][q] += acb[nt][q];\n")]),
    "no bf16 elision": lambda s: _swap(s, [
        ("  if constexpr (!A_EXACT) mma_tf32(c, as, bb0, bb1);\n"
         "  if constexpr (!B_EXACT) mma_tf32(c, ab, bs0, bs1);",
         "  mma_tf32(c, as, bb0, bb1);\n  mma_tf32(c, ab, bs0, bs1);")]),
    "8-tile state": lambda s: _swap(s, [
        ("static int state_ntiles(int N) { return N > 64 ? 8 : 4; }",
         "static int state_ntiles(int N) { return N > 0 ? 8 : 4; }")]),
    "tile branches": lambda s: _swap(s, [
        ("        for (int nt = 0; nt < NT; ++nt)\n"
         "          mma_3xtf32<",
         "        for (int nt = 0; nt < NT; ++nt)\n"
         "          if (n0 + nt * 8 < N) mma_3xtf32<"),
        ("    for (int pt = 0; pt < 8; ++pt) {\n"
         "      const float2 sv",
         "    for (int pt = 0; pt < 8; ++pt) {\n"
         "      if (pt * 8 >= P) break;\n      const float2 sv"),
        ("      for (int pt = 0; pt < 8; ++pt) {\n"
         "        const int pc = pt * 8 + g;",
         "      for (int pt = 0; pt < 8; ++pt) {\n"
         "        if (pt * 8 >= P) break;\n"
         "        const int pc = pt * 8 + g;")]),
}


def _swap(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"ssd_ablation: the text to replace is not in "
                             f"the source once: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def _libraries():
    """The kept build and every variant, built in parallel."""
    kept = KEPT.read_text()
    out = build_dir() / "ssd_ablation"
    out.mkdir(parents=True, exist_ok=True)
    libs = {"kept": CudaLibrary(str(KEPT), sd._bind)}
    for name, make in VARIANTS.items():
        path = out / f"ssd_{name.replace(' ', '_').replace('-', '')}.cu"
        path.write_text(make(kept))
        libs[name] = CudaLibrary(str(path), sd._bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()
    return libs


def _inputs(gen, b, s, h, p, n, g, dtype):
    def normal(shape, dt, scale=0.5):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    x = normal((b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(normal((b, s, h), torch.float32))
    A = -torch.exp(normal((h,), torch.float32, 0.3))
    return x, dt, A, normal((b, s, g, n), dtype), normal((b, s, g, n), dtype)


def _share(got, want, tol):
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def _device_ms(fn, reps):
    """Device ms a launch, ``reps`` launches queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise SystemExit("ssd_ablation: the spin ended before the launches "
                         "were queued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _run(args, chunk, ref, tol, reps):
    x, dt, A, B, C = args
    y, st = sd.ssd_scan(x, dt, A, B, C, chunk)
    share = max(_share(y, ref[0], tol), _share(st, ref[1], tol))
    cum, local = sd.ssd_chunk_state(x, dt, A, B, chunk)
    states, _ = sd.ssd_state_pass(local, cum, chunk)
    cb = sd.ssd_chunk_cb(B, C, chunk)
    scratch = states.clone()
    ms = {"call": _device_ms(lambda: sd.ssd_scan(x, dt, A, B, C, chunk),
                             reps),
          "chunk_state": _device_ms(
              lambda: sd.ssd_chunk_state(x, dt, A, B, chunk), reps),
          "state_pass": _device_ms(
              lambda: sd.ssd_state_pass(scratch, cum, chunk), reps),
          "chunk_cb": _device_ms(lambda: sd.ssd_chunk_cb(B, C, chunk), reps),
          "chunk_scan": _device_ms(
              lambda: sd.ssd_chunk_scan(x, dt, C, cum, cb, states, chunk),
              reps)}
    return share, ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(build_dir() / "ssd_ablation.json"))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssd_ablation: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = _libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = []
    for label, (b, s, h, p, n, g, chunk), dtype in CASES:
        args = _inputs(gen, b, s, h, p, n, g, dtype)
        data.append((f"{label} {str(dtype).split('.')[-1]}", args, chunk,
                     sd.ssd_scan_ref(*args, chunk), TOL[dtype]))
    names = list(VARIANTS)
    order = ["kept", *names, *reversed(names), "kept"] * opt.rounds
    readings = {name: {} for name in libs}
    for name in order:
        sd.LIBRARY = libs[name]
        parts = []
        for case, args, chunk, ref, tol in data:
            share, ms = _run(args, chunk, ref, tol, opt.reps)
            readings[name].setdefault(case, []).append({"share": share,
                                                        **ms})
            parts.append(f"{case}: share {share:.3f}, call {ms['call']:.4f}"
                         " (" + ", ".join(f"{k} {v:.4f}" for k, v in
                                          ms.items() if k != "call") + ")")
        print(f"[ablation] {name}: " + "; ".join(parts), flush=True)
    for name, cases in readings.items():
        valid = all(r["share"] <= 1 for runs in cases.values() for r in runs)
        print(f"[ablation] {name}: {'within' if valid else 'OUTSIDE'} the "
              "tolerance in every run" + ("" if valid else
                                          " (no ablation)"), flush=True)
    print(smi, flush=True)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text(json.dumps({"device": smi,
                                         "readings": readings}, indent=1))


if __name__ == "__main__":
    main()
