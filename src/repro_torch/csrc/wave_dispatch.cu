// Wave dispatch/dependency recurrence: one simulated core per lane.
//
// Replaces the TPU kernel `kernel` inside `_build_pallas_fn`
// (src/repro/core/batch_sim.py, the `pl.pallas_call` of the wave-execution
// backend).  Semantics are those of that kernel; everything is int32:
//
//   for j in 0..S-1, per lane e:
//     val_r  = (prod[j,r] < 0 || prod[j,r] >= j ? 0 : done[prod[j,r]])
//              + delta[j,r]
//     ready  = max(issue[j], max_r val_r)
//     t_p    = max(ready, port_free[p])   for every port lut[mask_id[j]] allows
//     best   = lexicographic argmin of (t_p, count[p], p)
//     valid[j] ? (done[j] = tmin + lat[j], port_free[best] = tmin + blk[j],
//                 count[best] += 1)
//              : (done[j] = 0, nothing else changes)
//
// A producer at or after its reader (j <= prod < S) reads 0: that row of
// `done` is not written yet, as in the plain version and the reference.
// When no port is allowed (or every candidate time is INT32_MAX) all ports
// tie on the INT32_MAX sentinel and the least-count, lowest-index port wins,
// as in the TPU kernel; a mask id outside 0..M-1 allows no port.  Sums wrap
// in 32 bits as the TPU kernel's do.  S must be below 2^27 (a count and a
// port index share one 32-bit word of the argmin key).
//
// Layout: every per-row input and `done` are (S, E) row-major, prod/delta
// (S, E, R), so the lanes of a block read one contiguous segment of row j.
// counts is (E, P).  The LUT (M, P) of bools is folded into M 32-bit port
// masks in shared memory once per block.
//
// What bounds it on an H100: the latency of one step.  Each lane is a serial
// chain of S dependent steps (a step reads `done` values that earlier steps
// of the same lane wrote), and a chunk has at most a few hundred lanes, so
// the time is S times the time of one step of one warp, plus filling the
// first tile.  Bytes and operations are far below the card's rates; what a
// step costs is its instructions and the two dependent shared-memory loads
// on its chain.
//
// Design: a block is one consumer warp (32 lanes, one thread each) and two
// producer warps.  The consumer walks the rows; everything it reads during
// a step is in shared memory or registers, and as little as possible is
// left for it to compute:
//  - `done` of the last WIN = 128 rows of the block's lanes sits in a ring
//    in shared memory, beside one row of zeros.  A producer at distance
//    1..WIN-1 is read from the ring, one farther back from global memory
//    (which the same thread wrote; a warp vote keeps that path off the
//    common step), one at or after the row (or none) from the zero row.
//    Every row's `done` (invalid rows' 0 too) goes to both, so the ring
//    holds exactly what global memory holds.
//  - the per-row inputs of a tile of T rows are brought by the producer
//    warps into a ring of STAGES = 4 stages with cp.async (16-byte copies
//    when E is a multiple of 4 and the planes are aligned, else 4-byte ones
//    and plain byte copies of `valid`), so tiles k + 1.. arrive while tile
//    k's steps run.  Before handing a tile over, each producer thread
//    rewrites what it copied: a mask id becomes its port bitmask, a
//    producer row becomes the ring word to read (or the zero row, or the
//    negated row of a far producer).  Producer and consumer hand stages over
//    through named barriers (a "full" and an "empty" one a stage).
//  - a block's walk ends at its last valid row (all its threads find it
//    first, scanning `valid` from the end); the rows after it are padding,
//    whose `done` the producers set to 0 once their tiles are handed over.
//    16% of the campaign's steps come after that row; walking them all
//    costs 10-13% more kernel time over the campaign on an H100.
//  - port_free and count live in registers, in a kernel instantiated at port
//    widths 8 and 32 (the launch takes the smallest >= P; the campaign runs
//    the 8-port one) and at 2 and 4 reads a row (unrolled; the campaign's R)
//    and any (a loop, whose reads wait on one another: 44% more kernel time
//    over the campaign when it runs R = 2 and 4 too).  Each port's candidate
//    is one 64-bit key (time, count, port), so the argmin is a branch-free
//    tree of 64-bit minima of depth log2(width).
//  - the producers keep up with the consumer only with 16-byte copies: with
//    4-byte ones the campaign's kernel time doubles.
// Shared memory at T = 32 rows: 4 stages of 32 x 32 x (16 + 8R + 1) bytes
// (50,176 at R = 4: issue, port mask, lat, blk, ring word, delta, valid),
// the 16.5 KB ring and 4M bytes of port masks: 217 KB at R = 4 and M <= 64.
// T halves until the total fits the 227 KB a block may use (larger R or
// M).  One block per 32 lanes: E = 256 runs on 8 SMs.

#include <cuda_runtime.h>
#include <atomic>
#include <limits.h>
#include <stdint.h>

#define MAXP 32
#define LANES 32               // lanes (consumer threads) a block
#define PRODUCERS 64           // producer threads a block
#define THREADS (LANES + PRODUCERS)
#define WIN 128                // rows of `done` in the ring (a power of 2)
#define ZERO_ROW (WIN * LANES)  // ring word of the row of zeros
#define STAGES 4               // tiles of per-row inputs in flight
#define MAX_TILE_ROWS 32
#define MAX_ROWS (1 << 27)     // S < 2^27: count * 32 + port fits 32 bits
#define SMEM_LIMIT 232448      // bytes of shared memory a block may use
#define BAR_FULL 1             // named barriers 1..4: stage s is full
#define BAR_EMPTY (1 + STAGES)  // named barriers 5..8: stage s is free
#define SIGN 0x80000000u       // flips int32 order into uint32 order
#define SCAN_ROUND (THREADS * 16)  // pieces of `valid` a round of the scan

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned int)a + (unsigned int)b);
}

// Named barriers between the producer and consumer warps (each warp
// reconverged first: the barrier instructions take whole warps).
__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Byte offsets of the arrays of one stage (T rows x LANES lanes).
struct StageLayout {
  int mask, lat, blk, prod, delta, valid, bytes;
  __host__ __device__ StageLayout(int T, int R) {
    const int plane = T * LANES * 4;  // one int32 (T, LANES) array
    mask = plane;
    lat = 2 * plane;
    blk = 3 * plane;
    prod = 4 * plane;
    delta = prod + plane * R;
    valid = delta + plane * R;
    bytes = valid + T * LANES;  // a multiple of 32
  }
};

__host__ __device__ inline size_t allow_bytes(int M) {
  return ((size_t)M * 4 + 15) / 16 * 16;
}

static size_t smem_bytes(int T, int R, int M) {
  return 16 + allow_bytes(M) + (size_t)(WIN + 1) * LANES * 4 +
         (size_t)STAGES * StageLayout(T, R).bytes;
}

// The most rows a tile (<= MAX_TILE_ROWS, a power of 2) whose stages fit
// beside the ring and the port masks; 0 if not even one row fits.
static int rows_per_tile(int R, int M) {
  for (int T = MAX_TILE_ROWS; T >= 1; T /= 2)
    if (smem_bytes(T, R, M) <= SMEM_LIMIT) return T;
  return 0;
}

// Piece i of the G-byte pieces that copy `rows` runs of `run` bytes is row
// i / (run / G), bytes (i % (run / G)) * G; producer thread `tid` owns the
// pieces tid, tid + PRODUCERS, ...  The copy and the rewrite walk the same
// pieces, so each producer thread rewrites only what it copied itself.
template <int G, typename F>
__device__ __forceinline__ void own_pieces(int rows, int run, int tid, F f) {
  const int per_row = run / G;
  const int total = rows * per_row;
  for (int i = tid; i < total; i += PRODUCERS) {
    const int t = i / per_row;
    f(t, (i - t * per_row) * G);
  }
}

template <int G>
__device__ __forceinline__ void copy_rows(char* dst, int dst_stride,
                                          const char* src, size_t src_stride,
                                          int rows, int run, int tid) {
  own_pieces<G>(rows, run, tid, [&](int t, int b) {
    char* d = dst + t * dst_stride + b;
    const char* s = src + t * src_stride + b;
    if (G == 16)
      cp_async16(d, s);
    else if (G == 4)
      cp_async4(d, s);
    else
      *d = *s;
  });
}

// A producer row of row j -> the ring word the consumer reads: the zero row
// when there is none or it is not earlier than j, its ring row when it is
// less than WIN rows back, else -(src + 1) (read from global memory).
__device__ __forceinline__ int ring_word(int src, int j) {
  if (src < 0 || src >= j) return ZERO_ROW;
  return j - src < WIN ? (src & (WIN - 1)) * LANES : -(src + 1);
}

// The ring word a consumer thread loads for `word`: itself when it names a
// ring row or the zero row, else the zero row (a far producer, whose value
// comes from global memory, or the unwritten words of a lane past E).
__device__ __forceinline__ int ring_index(int word) {
  return (int)min((unsigned int)word, (unsigned int)ZERO_ROW);
}

// Rewrite in place the mask ids (to port bitmasks; none outside 0..M-1) and
// the producer rows (to ring words) that this thread copied for the tile
// of rows j0...
template <int G>
__device__ __forceinline__ void rewrite(char* st, const StageLayout& L,
                                        int rows, int nl, int R, int tid,
                                        int j0, const unsigned int* allow,
                                        int M) {
  own_pieces<G>(rows, nl * 4, tid, [&](int t, int b) {
    int* w = (int*)(st + L.mask + t * LANES * 4 + b);
#pragma unroll
    for (int q = 0; q < G / 4; ++q)
      w[q] = (w[q] >= 0 && w[q] < M) ? (int)allow[w[q]] : 0;
  });
  own_pieces<G>(rows, nl * R * 4, tid, [&](int t, int b) {
    int* w = (int*)(st + L.prod + t * LANES * R * 4 + b);
#pragma unroll
    for (int q = 0; q < G / 4; ++q) w[q] = ring_word(w[q], j0 + t);
  });
}

// The last row in which any of the block's lanes is valid (-1: none),
// found by all the block's threads together, from the last row back, a
// round of SCAN_ROUND pieces at a time (a piece: 4 lanes' flags when `vec`,
// else one).  Two block barriers a round.
template <int G>
__device__ __forceinline__ int last_valid_scan(const bool* valid, int S,
                                               int E, int e0, int nl,
                                               int* found) {
  const int per_row = nl / G;
  const long long total = (long long)S * per_row;
  for (long long base = 0; base < total; base += SCAN_ROUND) {
    int mine = -1;
    const long long end = min(base + SCAN_ROUND, total);
#pragma unroll 4
    for (long long i = base + threadIdx.x; i < end; i += THREADS) {
      const int back = (int)(i / per_row), j = S - 1 - back;
      const char* row = (const char*)valid + (size_t)j * E + e0;
      const int c = (int)(i - (long long)back * per_row);
      const bool any = G == 4 ? ((const unsigned int*)row)[c] != 0u
                              : row[c] != 0;
      if (any) mine = max(mine, j);
    }
    if (mine >= 0) atomicMax(found, mine);
    __syncthreads();
    const int seen = *found;
    __syncthreads();  // every thread has read it before the next round
    if (seen >= 0) return seen;
  }
  return -1;
}

__device__ __forceinline__ int last_valid_row(const bool* valid, int S, int E,
                                              int e0, int nl, int vec,
                                              int* found) {
  if (threadIdx.x == 0) *found = -1;
  __syncthreads();
  return vec ? last_valid_scan<4>(valid, S, E, e0, nl, found)
             : last_valid_scan<1>(valid, S, E, e0, nl, found);
}

// PW: port width of the instance (a power of 2, >= P).  RW: the reads a row
// (R == RW), unrolled, or 0 for a loop over any R.
template <int PW, int RW>
__global__ void __launch_bounds__(THREADS)
wave_dispatch_kernel(const int* __restrict__ issue,
                     const int* __restrict__ mask_id,
                     const int* __restrict__ lat,
                     const int* __restrict__ blk,
                     const bool* __restrict__ valid,
                     const int* __restrict__ prod,
                     const int* __restrict__ delta,
                     const bool* __restrict__ lut, int* done,
                     int* __restrict__ counts, int S, int E, int R, int M,
                     int P, int T, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* found = (int*)smem;                          // the scan's result
  unsigned int* allow = (unsigned int*)(smem + 16);  // M port bitmasks
  int* ring = (int*)(smem + 16 + allow_bytes(M));   // (WIN + 1) x LANES
  char* stages = (char*)(ring + (WIN + 1) * LANES);
  const StageLayout L(T, R);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    unsigned int bits = 0u;
    for (int p = 0; p < P; ++p)
      if (lut[(size_t)m * P + p]) bits |= 1u << p;
    allow[m] = bits;
  }
  if (threadIdx.x < LANES) ring[ZERO_ROW + threadIdx.x] = 0;
  __syncthreads();

  const int e0 = blockIdx.x * LANES;
  const int nl = min(LANES, E - e0);  // lanes of this block that exist
  // The walk ends at the block's last valid row: every later row is
  // invalid (padding), so its `done` is 0 and it changes nothing.
  const int walk = last_valid_row(valid, S, E, e0, nl, vec, found) + 1;
  const int ntiles = (walk + T - 1) / T;

  if (threadIdx.x >= LANES) {  // producers: tile k into stage k % STAGES
    const int tid = threadIdx.x - LANES;
    const int* in[4] = {issue, mask_id, lat, blk};
    const int off[4] = {0, L.mask, L.lat, L.blk};
    for (int k = 0; k <= ntiles; ++k) {
      if (k < ntiles) {
        const int s = k % STAGES;
        if (k >= STAGES) bar_sync(BAR_EMPTY + s);
        char* st = stages + (size_t)s * L.bytes;
        const int rows = min(T, walk - k * T);
        const size_t row0 = (size_t)k * T * E + e0;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const char* src = (const char*)(in[a] + row0);
          if (vec)
            copy_rows<16>(st + off[a], LANES * 4, src, (size_t)E * 4, rows,
                          nl * 4, tid);
          else
            copy_rows<4>(st + off[a], LANES * 4, src, (size_t)E * 4, rows,
                         nl * 4, tid);
        }
        const char* psrc = (const char*)(prod + row0 * R);
        const char* dsrc = (const char*)(delta + row0 * R);
        const char* vsrc = (const char*)(valid + row0);
        if (vec) {
          copy_rows<16>(st + L.prod, LANES * R * 4, psrc, (size_t)E * R * 4,
                        rows, nl * R * 4, tid);
          copy_rows<16>(st + L.delta, LANES * R * 4, dsrc, (size_t)E * R * 4,
                        rows, nl * R * 4, tid);
          copy_rows<4>(st + L.valid, LANES, vsrc, E, rows, nl, tid);
        } else {
          copy_rows<4>(st + L.prod, LANES * R * 4, psrc, (size_t)E * R * 4,
                       rows, nl * R * 4, tid);
          copy_rows<4>(st + L.delta, LANES * R * 4, dsrc, (size_t)E * R * 4,
                       rows, nl * R * 4, tid);
          copy_rows<1>(st + L.valid, LANES, vsrc, E, rows, nl, tid);
        }
        cp_async_commit();
      }
      if (k >= 1) {  // tile k - 1 has landed: rewrite it and hand it over
        if (k < ntiles)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        const int kp = k - 1;
        char* st = stages + (size_t)(kp % STAGES) * L.bytes;
        const int j0 = kp * T, rows = min(T, walk - j0);
        if (vec)
          rewrite<16>(st, L, rows, nl, R, tid, j0, allow, M);
        else
          rewrite<4>(st, L, rows, nl, R, tid, j0, allow, M);
        bar_arrive(BAR_FULL + kp % STAGES);
      }
    }
    // the rows past the walk: done = 0
    const long long n = (long long)(S - walk) * nl;
    for (long long i = tid; i < n; i += PRODUCERS) {
      const int t = (int)(i / nl);
      done[(size_t)(walk + t) * E + e0 + (int)(i - (long long)t * nl)] = 0;
    }
    return;
  }

  // the consumer warp: one lane a thread
  const int lane = threadIdx.x;
  const bool active = lane < nl;
  int* done_row = done + e0 + lane;  // done[j, e], advanced by E a row
  // port state: port_free with its sign bit flipped (so that unsigned
  // order is signed order), and count * 32 + port (a port past P never
  // wins: its count field is all ones)
  unsigned int pf[PW], cp[PW];
#pragma unroll
  for (int p = 0; p < PW; ++p) {
    pf[p] = SIGN;
    cp[p] = p < P ? (unsigned int)p : 0xffffffe0u | p;
  }
  const int* my_ring = ring + lane;
  constexpr int RU = RW > 0 ? RW : 1;  // registers of a row's reads
  const int RR = RW > 0 ? RW : R;       // reads a row (R == RW if RW > 0)
  for (int k = 0; k < ntiles; ++k) {
    const int s = k % STAGES;
    bar_sync(BAR_FULL + s);
    const char* st = stages + (size_t)s * L.bytes;
    const int j0 = k * T, rows = min(T, walk - j0);
    // row t of the stage, this lane; advanced a row a step
    const int* s_issue = (const int*)st + lane;
    const int* s_allow = (const int*)(st + L.mask) + lane;
    const int* s_lat = (const int*)(st + L.lat) + lane;
    const int* s_blk = (const int*)(st + L.blk) + lane;
    const int* s_word = (const int*)(st + L.prod) + lane * RR;
    const int* s_delta = (const int*)(st + L.delta) + lane * RR;
    const char* s_valid = (const char*)(st + L.valid) + lane;
    // T divides WIN, so a tile's rows take consecutive ring rows
    int* ring_w = ring + (j0 & (WIN - 1)) * LANES + lane;
    int word[RU];
    if (RW > 0) {
#pragma unroll
      for (int r = 0; r < RU; ++r) word[r] = s_word[r];
    }
    for (int t = 0; t < rows; ++t) {
      int ready;
      bool ok;
      if (RW > 0) {
        // the ring reads first: they wait on the last step's store ...
        int v[RU];
#pragma unroll
        for (int r = 0; r < RU; ++r) v[r] = my_ring[ring_index(word[r])];
        // ... then the rest of this row and the next row's words, all
        // independent of the chain
        const int isu = *s_issue;
        ok = active & (*s_valid != 0);
        int de[RU], next[RU];
        const int ahead = t + 1 < rows ? LANES * RR : 0;
#pragma unroll
        for (int r = 0; r < RU; ++r) {
          de[r] = s_delta[r];
          next[r] = s_word[ahead + r];
        }
        bool far = false;
#pragma unroll
        for (int r = 0; r < RU; ++r) far |= word[r] < 0;
        if (__any_sync(0xffffffffu, far & ok)) {  // a producer WIN+ back
#pragma unroll
          for (int r = 0; r < RU; ++r)
            if (ok && word[r] < 0)
              v[r] = done[(size_t)(-word[r] - 1) * E + e0 + lane];
        }
        ready = isu;
#pragma unroll
        for (int r = 0; r < RU; ++r) ready = max(ready, wrap_add(v[r], de[r]));
#pragma unroll
        for (int r = 0; r < RU; ++r) word[r] = next[r];
      } else {  // any R: the reads one after another
        ok = active & (*s_valid != 0);
        ready = *s_issue;
        for (int r = 0; r < R; ++r) {
          const int w = s_word[r];
          int v = my_ring[ring_index(w)];
          if (w < 0 && ok) v = done[(size_t)(-w - 1) * E + e0 + lane];
          ready = max(ready, wrap_add(v, s_delta[r]));
        }
      }
      // the argmin of (t_p, count, p) as the minimum of 64-bit keys: t_p
      // with its sign bit flipped (all ones for a port not allowed: the
      // INT32_MAX sentinel) above count * 32 + p
      const unsigned int a = (unsigned int)*s_allow;
      const unsigned int ready_b = (unsigned int)ready ^ SIGN;
      unsigned long long key[PW];
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        const unsigned int hi = ((a >> p) & 1u) ? max(ready_b, pf[p])
                                                : 0xffffffffu;
        key[p] = ((unsigned long long)hi << 32) | cp[p];
      }
#pragma unroll
      for (int w = 1; w < PW; w *= 2)
#pragma unroll
        for (int p = 0; p < PW; p += 2 * w) key[p] = min(key[p], key[p + w]);
      const int tmin = (int)((unsigned int)(key[0] >> 32) ^ SIGN);
      const int best = (int)(key[0] & 31u);
      const int out = ok ? wrap_add(tmin, *s_lat) : 0;
      *ring_w = out;
      if (active) *done_row = out;
      const unsigned int free_b = (unsigned int)wrap_add(tmin, *s_blk) ^ SIGN;
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        if (ok && p == best) {
          pf[p] = free_b;
          cp[p] += 32u;
        }
      }
      done_row += E;
      ring_w += LANES;
      s_issue += LANES;
      s_allow += LANES;
      s_lat += LANES;
      s_blk += LANES;
      s_valid += LANES;
      s_word += LANES * RR;
      s_delta += LANES * RR;
    }
    if (k + STAGES < ntiles) bar_arrive(BAR_EMPTY + s);  // the producers
  }                                                     // wait for it
  if (active) {
#pragma unroll
    for (int p = 0; p < PW; ++p)  // constant indices keep cp in registers
      if (p < P) counts[(size_t)(e0 + lane) * P + p] = (int)(cp[p] >> 5);
  }
}

typedef void (*wave_kernel_t)(const int*, const int*, const int*, const int*,
                              const bool*, const int*, const int*,
                              const bool*, int*, int*, int, int, int, int,
                              int, int, int);

// The smallest instantiated port width >= P (0 if P is out of range).
extern "C" int wave_dispatch_port_width(int P) {
  if (P < 1 || P > MAXP) return 0;
  return P <= 8 ? 8 : 32;
}

extern "C" int wave_dispatch_rows_per_tile(int R, int M) {
  return R < 1 || M < 0 ? 0 : rows_per_tile(R, M);
}

extern "C" int wave_dispatch_max_rows(void) { return MAX_ROWS - 1; }

// Every instance, indexed by kernel_index.
static const wave_kernel_t KERNELS[] = {
    wave_dispatch_kernel<8, 2>,  wave_dispatch_kernel<8, 4>,
    wave_dispatch_kernel<8, 0>,  wave_dispatch_kernel<32, 2>,
    wave_dispatch_kernel<32, 4>, wave_dispatch_kernel<32, 0>};

static int kernel_index(int PW, int R) {
  return (PW == 8 ? 0 : 3) + (R == 2 ? 0 : R == 4 ? 1 : 2);
}

// Lets every instance take SMEM_LIMIT bytes of dynamic shared memory, once
// a device (a bit a device in `ready`; threads that race set the same
// values).
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (ready.load() & bit) return cudaSuccess;
  for (const wave_kernel_t kernel : KERNELS) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return err;
  }
  ready.fetch_or(bit);
  return cudaSuccess;
}

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() of the launch; does not synchronize and
// allocates nothing.
extern "C" int wave_dispatch_launch(const void* issue, const void* mask_id,
                                    const void* lat, const void* blk,
                                    const void* valid, const void* prod,
                                    const void* delta, const void* lut,
                                    void* done, void* counts, int S, int E,
                                    int R, int M, int P, void* stream) {
  if (E <= 0 || S <= 0) return 0;
  const int PW = wave_dispatch_port_width(P);
  const int T = wave_dispatch_rows_per_tile(R, M);
  if (PW == 0 || T == 0 || S >= MAX_ROWS) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const wave_kernel_t kernel = KERNELS[kernel_index(PW, R)];
  const size_t smem = smem_bytes(T, R, M);
  // 16-byte copies need every row segment 16-byte aligned: E a multiple
  // of 4 and the int32 planes (4 bytes for `valid`) aligned at their start
  const uintptr_t planes = (uintptr_t)issue | (uintptr_t)mask_id |
                           (uintptr_t)lat | (uintptr_t)blk |
                           (uintptr_t)prod | (uintptr_t)delta;
  const int vec = E % 4 == 0 && planes % 16 == 0 && (uintptr_t)valid % 4 == 0;
  const int blocks = (E + LANES - 1) / LANES;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)issue, (const int*)mask_id, (const int*)lat,
      (const int*)blk, (const bool*)valid, (const int*)prod,
      (const int*)delta, (const bool*)lut, (int*)done, (int*)counts, S, E,
      R, M, P, T, vec);
  return (int)cudaGetLastError();
}

extern "C" int wave_dispatch_max_ports(void) { return MAXP; }
