// The min-cut port bound of a wave of blocks, exact in integers.
//
// Replaces the device kernel `port_bound_kernel` of
// `BatchPredictor._compile_kernel` in src/repro/service/batch_predictor.py
// (plain jax, not a Pallas kernel).  Same function: per row of u (B x C
// int32, one block's summed uop count for each port combination),
// demand[s] = sum_c u[c] * mask[c, s] over the model's min-cut candidate
// sets (mask C x S, 0/1; size S, each candidate's port count, >= 1), and
// the pair (num, den) = (demand[s*], size[s*]) whose ratio is the largest,
// found by the exact compare an * bd < bn * ad from (0, 1).  The result is
// one (2, B) int32 array, num in row 0 and den in row 1; the host divides
// num / den in float64.  Two equal ratios may give two different pairs (the
// jax reduce may also pick either); their quotients are the same double, so
// only quotients are compared with the plain version.
//
// The caller keeps every row total times the largest size below 2^31 (the
// reference's guard, which routes other waves to the host), so demand fits
// int32; the cross products are taken in int64 all the same.
//
// What bounds it on this card: the launch, then bytes.  The bytes are
// 4 * (B*C + C*S + S + 2*B): at the widest served wave, (B, C, S) =
// (9936, 11, 71), 0.52 MB, 0.16 us at the HBM rate, against ~1.9 us for a
// bare launch.  The work is at most 7.7 M integer adds, ~1e-5 ms at the
// int8 tensor-core rate, and each add is a gather from a 0/1 mask that no
// tensor-core tile shape holds; so the kernel uses no tensor cores, and
// what it can win is latency: the rounds of CTAs, the serial trips to
// memory, the warps each CTA starts and the instructions each row issues
// (at the widest wave the SMs' issue is what is left).  The design, point
// by point:
//  1. Persistent CTAs, never more than there are row tiles, so all of
//     them are resident in one round: one a streaming multiprocessor
//     while a CTA's share of the rows runs at 32 lanes a row in one pass
//     (B up to 16 rows an SM), else at most kCtasPerSm (as many as its
//     shared memory holds).  A tile is a CTA's share of the rows,
//     ceil(B / CTAs), at least kMinThreads lanes' worth (a small wave
//     takes fewer, wider CTAs: each copies the table with more warps)
//     and at most what kUbufBytes holds (at C = 11, ~98,000 rows in
//     all); above that each CTA walks tiles tile = blockIdx.x,
//     + gridDim.x, ...  A CTA starts only the warps its tile needs.
//  2. Each CTA copies the candidate table (the sizes, then the 0/1 int
//     mask) into shared memory once, before its first tile, with cp.async
//     in flight with the first tile of u: one trip to memory.  The mask is
//     read as one run, so a warp's requests cover whole lines: every CTA
//     reads the same lines of L2 at once, and a row a warp (a row of 9-11
//     ints straddles two lines) measured slower with many CTAs.
//     The mask's rows are padded with zeros (sizes with ones) to a multiple
//     of a pass of candidates; the padding is stored first, since a store
//     issued after a cp.async waits for it.  A table above the 48 KB a
//     block takes by default opts in to dynamic shared memory with
//     cudaFuncSetAttribute, up to the card's opt-in limit (227 KB on an
//     H100); only a larger one is read through L1/L2.  (The mask as one
//     32-bit set a candidate measured slower: see the ablation.)
//  3. The row tile of u (contiguous) is copied to shared memory with
//     cp.async, 16 bytes a copy, 4 bytes for the unaligned head and tail (u
//     need only be 4-byte aligned; a row is C*4 bytes); with more tiles
//     than CTAs, two buffers keep tile k + 1 in flight while tile k is
//     computed.  Each row's counts are read from device memory once.
//  4. Several rows a warp, every lane busy: a group of G lanes takes a row,
//     G chosen at launch as the widest of 32, 16, 8, 4 that runs a CTA's
//     share in one pass of at most kMaxThreads threads: 32 lanes a row
//     for a small wave, 8 at the widest served one.  When
//     C <= 32 a ballot gives the group its row's nonzero combinations (a
//     served row has ~3 of its 9-11), and the first kSlots of them sit in
//     registers as (offset into the mask, count).  Lane l of the group
//     holds K candidates at once, s = s0 + l + G * k, each with its own best
//     pair (K of 1-4 chosen at launch to pad the rows least); a demand is a
//     shared-memory load and a multiply-add a slot, at fixed offsets from
//     one address, with no branch (an empty slot adds 0 times mask row 0),
//     and a loop over any further nonzeros.
//  5. The lane's K pairs, then the group's, take K - 1 compares and
//     log2(G) butterfly shuffles with the same exact compare.
//  6. One output, (2, B), so the host copies the result back once.
// u that two buffers cannot hold (C above ~440) is read in place, and so is
// the table beyond the opt-in limit, with a plain loop over candidates; the
// same loop serves C > 32.  The kernel launches at exactly B rows (no
// padding to a shape bucket: there is no compile per shape to avoid), and
// a row with no uops gives (0, 1).
//
// src/repro_torch/tools/port_bound_ablation.py times variants of this
// text, each with one part of the design replaced, against it.
//
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxThreads = 512;        // threads a CTA, at most
constexpr int kMinThreads = 256;        // lanes of rows a CTA, at least
constexpr int kCtasPerSm = 2;           // persistent CTAs an SM, at most
constexpr int kSlots = 4;               // a row's nonzero counts in registers
constexpr int kUbufBytes = 32 * 1024;   // the two u buffers, at most
constexpr int kSmemDefault = 48 * 1024;  // a block's shared memory unasked
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kMaxThreads % 32 == 0 && kMaxThreads <= 1024,
              "kMaxThreads is whole warps");

struct Args {
  const int* u;
  const int* mask;
  const int* size;
  int* out;              // (2, rows): num, then den
  long long rows;
  long long tile_rows;   // rows a tile
  long long tiles;       // ceil(rows / tile_rows)
  int C, S;
  int Sp;                // the mask's row length in shared memory (>= S)
  int ubuf;              // ints a u buffer (a multiple of 4); 0: u in place
};

// an / ad < bn / bd, exactly (ad, bd > 0)
__device__ __forceinline__ bool ratio_less(int an, int ad, int bn, int bd) {
  return (long long)an * bd < (long long)bn * ad;
}

__device__ __forceinline__ void copy4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ints from g back to its 16-byte boundary: a tile lands at buf + head, so
// that its 16-byte-aligned ints land on 16-byte-aligned shared memory
__device__ __forceinline__ int tile_head(const int* g) {
  return (int)(((uintptr_t)g >> 2) & 3);
}

__device__ __forceinline__ const int* tile_start(const Args& a,
                                                 long long tile) {
  return a.u + tile * a.tile_rows * a.C;
}

__device__ __forceinline__ int tile_nrows(const Args& a, long long tile) {
  return (int)min(a.tile_rows, a.rows - tile * a.tile_rows);
}

// Row tile `tile` of u into buf + tile_head: 16-byte copies for the
// aligned body, 4-byte ones for at most 3 ints on each side.
__device__ __forceinline__ void copy_tile(int* buf, const Args& a,
                                          long long tile) {
  const int* g = tile_start(a, tile);
  const int n = tile_nrows(a, tile) * a.C;
  int* d = buf + tile_head(g);
  const int head = min(n, (4 - tile_head(g)) & 3);
  const int chunks = (n - head) >> 2;
  const int tail = head + 4 * chunks;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    copy16(d + head + 4 * i, g + head + 4 * i);
  const int t = threadIdx.x;
  if (t < head) copy4(d + t, g + t);
  if (t >= 4 && t - 4 < n - tail) copy4(d + tail + t - 4, g + tail + t - 4);
}

// kRowBits: C <= 32, only a row's nonzero combinations are summed (a
// ballot gives the set) and the mask's rows are padded to a.Sp columns (a
// multiple of G * K: zero mask, size 1), so a lane's K candidates are fixed
// offsets from one address.  kTabSmem: the table in shared memory, else
// read through L1/L2.  kTile: u tiles copied to shared memory, else read
// in place.
template <int G, int K, bool kRowBits, bool kTabSmem, bool kTile>
__global__ void __launch_bounds__(kMaxThreads, 2)
    port_bound_kernel(const Args a) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G");
  constexpr unsigned kGroupBits =
      G == 32 ? kFullMask : (1u << (G % 32)) - 1u;
  extern __shared__ __align__(16) int smem[];
  const int Sp = a.Sp;                    // the mask's row length
  int* const size_s = smem + 2 * a.ubuf;  // the table: sizes,
  int* const mask_s = size_s + Sp;        // then the mask
  const int grp = threadIdx.x / G;        // row of a pass
  const int lg = threadIdx.x % G;         // lane of the group
  const int gw = (threadIdx.x & 31) / G;  // group of the warp
  const int pass_rows = blockDim.x / G;
  long long tile = blockIdx.x;

  if (kTabSmem) {
    // the padding first: a store after a cp.async waits for it
    const int pad = Sp - a.S;
    for (int i = threadIdx.x; i < (a.C + 1) * pad; i += blockDim.x) {
      const int row = i / pad, s = a.S + i % pad;
      if (row == 0)
        size_s[s] = 1;
      else
        mask_s[(row - 1) * Sp + s] = 0;
    }
  }
  if (kTile) copy_tile(smem, a, tile);
  if (kTabSmem) {  // the mask as one run: a CTA's requests coalesce
    for (int s = threadIdx.x; s < a.S; s += blockDim.x)
      copy4(size_s + s, a.size + s);
    for (int i = threadIdx.x; i < a.C * a.S; i += blockDim.x) {
      const int c = i / a.S;
      copy4(mask_s + c * Sp + (i - c * a.S), a.mask + i);
    }
  }
  copy_commit();
  for (int it = 0; tile < a.tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (kTile && next < a.tiles)
      copy_tile(smem + ((it + 1) & 1) * a.ubuf, a, next);
    copy_commit();  // an empty group on the last tile keeps the count
    copy_wait_older();
    __syncthreads();

    const long long base = tile * a.tile_rows;
    const int nrows = tile_nrows(a, tile);
    // the tile's rows: at smem[ubase] (kTile), else in place
    const int ubase = (it & 1) * a.ubuf + tile_head(tile_start(a, tile));
    for (int r = grp; r - grp < nrows; r += pass_rows) {
      const bool valid = r < nrows;
      if (!__any_sync(kFullMask, valid)) break;  // the warp's rows are done
      const int urow_s = ubase + (valid ? r : 0) * a.C;  // kRowBits: kTile
      int an[K], ad[K];  // the best pair of each of a lane's K candidates
#pragma unroll
      for (int k = 0; k < K; ++k) {
        an[k] = 0;
        ad[k] = 1;
      }
      if (kRowBits) {
        unsigned nz = 0;  // the row's nonzero combinations
        for (int c0 = 0; c0 < a.C; c0 += G) {
          const int c = c0 + lg;
          const unsigned b = __ballot_sync(
              kFullMask, valid && c < a.C && smem[urow_s + c] != 0);
          nz |= ((b >> (gw * G)) & kGroupBits) << c0;
        }
        // the first kSlots nonzeros: mask row offset, count
        const int n = __popc(nz);
        int off[kSlots], us[kSlots];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const unsigned bit = nz & (0u - nz);
          nz ^= bit;
          const int c = i < n ? __ffs((int)bit) - 1 : 0;
          off[i] = c * Sp;
          us[i] = i < n ? smem[urow_s + c] : 0;
        }
        for (int s0 = lg; s0 < Sp; s0 += G * K) {
          int d[K], bd[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            d[k] = 0;
            bd[k] = size_s[s0 + G * k];
          }
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {  // an empty slot adds 0
            const int* col = mask_s + off[i] + s0;
#pragma unroll
            for (int k = 0; k < K; ++k) d[k] += col[G * k] * us[i];
          }
          for (unsigned b = nz; b; b &= b - 1) {  // past kSlots nonzeros
            const int c = __ffs((int)b) - 1;
            const int* col = mask_s + c * Sp + s0;
            const int uc = smem[urow_s + c];
#pragma unroll
            for (int k = 0; k < K; ++k) d[k] += col[G * k] * uc;
          }
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (ratio_less(an[k], ad[k], d[k], bd[k])) {
              an[k] = d[k];
              ad[k] = bd[k];
            }
        }
      } else if (valid) {
        const int* urow =
            kTile ? smem + urow_s : tile_start(a, tile) + r * a.C;
        for (int s = lg; s < a.S; s += G) {
          int d = 0;
          for (int c = 0; c < a.C; ++c) {
            const int uc = urow[c];
            if (uc == 0) continue;
            d += (kTabSmem ? mask_s[c * Sp + s]
                           : __ldg(a.mask + (long long)c * a.S + s)) *
                 uc;
          }
          const int bd = kTabSmem ? size_s[s] : __ldg(a.size + s);
          if (ratio_less(an[0], ad[0], d, bd)) {
            an[0] = d;
            ad[0] = bd;
          }
        }
      }
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (ratio_less(an[0], ad[0], an[k], ad[k])) {
          an[0] = an[k];
          ad[0] = ad[k];
        }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const int bn = __shfl_xor_sync(kFullMask, an[0], off);
        const int bd = __shfl_xor_sync(kFullMask, ad[0], off);
        if (ratio_less(an[0], ad[0], bn, bd)) {
          an[0] = bn;
          ad[0] = bd;
        }
      }
      if (valid && lg == 0) {
        a.out[base + r] = an[0];
        a.out[a.rows + base + r] = ad[0];
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
}

struct Device {
  int sms, smem_sm, smem_reserved, smem_max;
};

template <int G, int K, bool kRowBits, bool kTabSmem, bool kTile>
static int launch(const Args& a, size_t table_bytes, const Device& dev,
                  cudaStream_t stream) {
  auto kernel = port_bound_kernel<G, K, kRowBits, kTabSmem, kTile>;
  const size_t smem = 2 * (size_t)a.ubuf * sizeof(int) + table_bytes;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // as many CTAs as fit an SM at once (registers allow 2: launch bounds)
  long long per_sm = dev.smem_sm / ((long long)smem + dev.smem_reserved);
  per_sm = per_sm < 1 ? 1 : per_sm;
  per_sm = per_sm > kCtasPerSm ? kCtasPerSm : per_sm;
  const long long round = dev.sms * per_sm;
  const long long grid = a.tiles > round ? round : a.tiles;
  // the warps a tile's rows need, one pass if they fit
  long long threads = (a.tile_rows * G + 31) / 32 * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  kernel<<<(unsigned)grid, (unsigned)threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the table's bytes, the mask's rows Sp columns long
static size_t table_bytes(const Args& a) {
  return ((size_t)a.C * a.Sp + a.Sp) * sizeof(int);
}

// C <= 32 and a table in shared memory: K, the candidates a lane holds,
// wastes the fewest padded columns (ties: the larger K, fewer chunks)
template <int G>
static int launch_rows(Args a, size_t room, const Device& dev,
                       cudaStream_t st) {
  int best = 0;
  long long best_sp = 0;
  for (int k = 4; k >= 1; --k) {
    const long long sp = (a.S + G * k - 1) / (G * k) * (G * k);
    if (best == 0 || sp < best_sp) {
      best = k;
      best_sp = sp;
    }
  }
  a.Sp = (int)best_sp;
  const size_t bytes = table_bytes(a);
  if (bytes > room) return -1;  // padded, it does not fit
  switch (best) {
    case 1: return launch<G, 1, true, true, true>(a, bytes, dev, st);
    case 2: return launch<G, 2, true, true, true>(a, bytes, dev, st);
    case 3: return launch<G, 3, true, true, true>(a, bytes, dev, st);
    default: return launch<G, 4, true, true, true>(a, bytes, dev, st);
  }
}

// the kernel for these sizes: which table, which copy of u
template <int G>
static int dispatch(Args a, const Device& dev, cudaStream_t st) {
  const size_t limit = (size_t)dev.smem_max;
  // a buffer: a tile's ints, 3 more for the head, a multiple of 4
  const size_t ubuf = ((size_t)a.tile_rows * a.C + 3 + 3) & ~(size_t)3;
  a.ubuf = 2 * ubuf * sizeof(int) <= limit ? (int)ubuf : 0;
  const size_t room = limit - 2 * (size_t)a.ubuf * sizeof(int);
  if (a.C <= 32 && a.ubuf) {
    const int e = launch_rows<G>(a, room, dev, st);
    if (e >= 0) return e;
  }
  a.Sp = a.S;
  const bool fits = table_bytes(a) <= room;
  const size_t bytes = fits ? table_bytes(a) : 0;
  if (a.ubuf)
    return fits ? launch<G, 1, false, true, true>(a, bytes, dev, st)
                : launch<G, 1, false, false, true>(a, 0, dev, st);
  return fits ? launch<G, 1, false, true, false>(a, bytes, dev, st)
              : launch<G, 1, false, false, false>(a, 0, dev, st);
}

extern "C" int port_bound_launch(const void* u, const void* mask,
                                 const void* size, void* out,
                                 long long rows, int C, int S, void* stream) {
  if (rows <= 0) return 0;
  if (C < 0 || S < 0) return cudaErrorInvalidValue;
  int id;
  Device dev;
  cudaError_t e = cudaGetDevice(&id);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&dev.sms, cudaDevAttrMultiProcessorCount, id);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &dev.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, id);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &dev.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, id);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &dev.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
  if (e != cudaSuccess) return (int)e;

  Args a;
  a.u = (const int*)u;
  a.mask = (const int*)mask;
  a.size = (const int*)size;
  a.out = (int*)out;
  a.rows = rows;
  a.C = C;
  a.S = S;
  // a CTA's share of a round, and the widest group that runs it in one
  // pass of kMaxThreads; a round is one CTA an SM while its share runs at
  // 32 lanes a row, else kCtasPerSm
  long long round = dev.sms;
  if ((rows + round - 1) / round * 32 > kMaxThreads) round *= kCtasPerSm;
  const long long share = (rows + round - 1) / round;
  int g = 32;
  while (g > 4 && share * g > kMaxThreads) g /= 2;
  // a tile: the share, at least kMinThreads / g rows, at most what half of
  // kUbufBytes holds (at least a pass)
  const long long pass = kMaxThreads / g;
  const long long least = kMinThreads / g > 0 ? kMinThreads / g : 1;
  const long long per_buf = (kUbufBytes / 2 / 4 - 8) / (C > 0 ? C : 1);
  const long long cap = per_buf > pass ? per_buf : pass;
  const long long want = share > least ? share : least;
  a.tile_rows = want < cap ? want : cap;
  a.tiles = (rows + a.tile_rows - 1) / a.tile_rows;
  cudaStream_t st = (cudaStream_t)stream;
  switch (g) {
    case 32: return dispatch<32>(a, dev, st);
    case 16: return dispatch<16>(a, dev, st);
    case 8: return dispatch<8>(a, dev, st);
    default: return dispatch<4>(a, dev, st);
  }
}
