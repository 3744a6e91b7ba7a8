// Mamba2 SSD (state-space duality) chunk scan, chunk-parallel, with its
// products on the tensor cores.
//
// Replaces the TPU kernel `_ssd_kernel` (the `pl.pallas_call` of
// `ssd_scan`) in src/repro/kernels/ssd_scan.py.  Per chunk of Q steps, in
// f32, with the (P, N) state that enters the chunk:
//
//   xbar  = x * dt                       cum = cumsum(dt * A)
//   L[i,j] = exp(cum_i - cum_j) for i >= j, 0 elsewhere
//   y     = ((C B^T) . L) xbar + (C . exp(cum)) state^T
//   state = exp(cum[-1]) * state + xbar^T (B . exp(cum[-1] - cum))
//
// y is rounded to nearest into x's dtype; the final state is f32.  exp is
// evaluated only where i >= j: above the diagonal cum_i - cum_j > 0 and exp
// can overflow to inf, and inf * 0 is NaN.  Head h reads the B and C of
// group h / (H / G).
//
// What bounds it on this card: at Mamba2-2.7B's width (Q = 256, P = 64,
// N = 128) the bytes of x and y (~150 FLOP a byte of f32 x, B, C and y, so
// the products have to run on the tensor cores to come near the byte
// bound).  The TPU kernel walks its chunks in order on one core with the
// state in VMEM; carried over, one CTA per (batch, head) walks 16 chunks
// and the grid has 160 CTAs.  Only the (P, N) state update is serial
// across chunks, and it is elementwise in the state, so the call is four
// passes, launched back to back on one stream:
//
//   1. ssd_chunk_state, one CTA per (batch, head, chunk): cum by a warp
//      scan (written out), and the chunk's own state from zero,
//      xbar^T (B . exp(cl - cum)) with cl = cum[-1], a (P x Q)(Q x N)
//      product, written to `local` (b, H, chunks, P, N).
//   2. ssd_state_pass, one thread per 4 state elements of a (batch, head):
//      walks the chunks in order, S <- exp(cl_c) * S + local_c (the
//      reference's operations in its order), writes the state that enters
//      each chunk over `local` and the final state.  Bytes-bound.
//   3. ssd_chunk_cb, one CTA per (batch, group, chunk, 64-row tile): the
//      scores C B^T of the tile's rows against every column at or below
//      them, once a group (B and C do not depend on the head), into `cb`
//      (b, G, chunks, Q, Q); the tiles above the diagonal are not written.
//   4. ssd_chunk_scan, one CTA per (batch, head, chunk, 64-row tile): y_off
//      = exp(cum_i) (C state^T) from the entering state, then y_diag over
//      the column tiles at or below the diagonal, the masked scores
//      s_ij exp(cum_i - cum_j) dt_j times x, written in x's dtype.
//
// Products: mma.sync on the tensor cores.  f32 operands and every f32
// intermediate (x times the decay weights, the masked scores, the state)
// run in 3xTF32 with m16n8k8: x = big + small, big x's top 10 mantissa
// bits, small the remainder (read as tf32, its low bits dropped), summed
// as small*big + big*small + big*big; each warp splits the fragments it
// loads, and the product with the small part of an operand read from
// bf16 (exact in tf32) is left out.  bf16 B and C make the scores with
// m16n8k16 on the stored values, exact products summed in f32.  Tiles are
// 64 rows, fed to shared memory by 16-byte cp.async (two stages where a
// loop walks tiles), or by plain loads where a row is not a 16-byte
// multiple; operands one warp alone reads go from L2 straight into
// registers.  The k index of every 8-deep tf32 step is permuted (fragment
// column t holds element 2t, column t + 4 element 2t + 1), so that each
// lane's A and B values of a step are neighbours in memory; shared rows
// are padded so that a warp's fragment loads hit distinct banks.  Every
// warp runs a fixed number of n8 tiles (operands zero-padded to them), so
// that the compiler interleaves the tiles' loads and products.  P <= 64,
// N <= 128.
//
// x and y are f32 or bf16, B and C (one type) f32 or bf16, dt and A f32.
// The C entry points launch on the stream they are given, do not
// synchronize, allocate nothing (the wrapper passes the scratch) and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define SSD_MAX_P 64
#define SSD_MAX_N 128
#define SSD_T 64         // rows of a tile
#define SSD_SC_LD 72     // row length of a staged score tile (floats)
#define SSD_STATE_THREADS 256
#define SSD_TILE_THREADS 128
#define SSD_PASS_THREADS 256
#define SSD_MAX_SMEM (227 * 1024)

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ helpers
__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// two neighbours of a row as f32
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared rows of W elements (W a multiple of 16), padded so that a warp's
// fragment loads hit 32 distinct banks (g = lane / 4, t = lane % 4):
// "column" reads (lanes at rows 2t and 2t + 1, column g) need a row of
// 4 mod 16 words in f32 and 8 mod 16 elements in bf16; "pair" reads (lanes
// at row g, columns 2t and 2t + 1) a row of 8 mod 16 elements in either.
template <typename E>
__host__ __device__ __forceinline__ int col_ld(int W) {
  return W + (sizeof(E) == 4 ? 4 : 8);
}
__host__ __device__ __forceinline__ int pair_ld(int W) { return W + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A tile of `tile_rows` x W elements into `dst` (rows of `ld`): element
// (r, c) is src[r * stride + c] for r < rows and c < width, else 0.  With
// `vec` (width, stride and src 16-byte multiples) by 16-byte cp.async, which
// the caller commits and waits for; else by plain loads and stores.
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, int ld, const E* src,
                                          size_t stride, int tile_rows,
                                          int rows, int width, int W,
                                          bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(E);
    const int per_row = W / V;
    for (int e = threadIdx.x; e < tile_rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const bool in = r < rows && c < width;
      cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < tile_rows * W; e += blockDim.x) {
      const int r = e / W, c = e - r * W;
      dst[r * ld + c] =
          (r < rows && c < width) ? src[r * stride + c] : from_f32<E>(0.f);
    }
  }
}

// c += a * b, m16n8k8, tf32 operands, f32 accumulators.  Fragments (PTX
// ISA; g = lane / 4, t = lane % 4): A a0..a3 at (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B b0, b1 at (k=t, n=g), (k=t+4, n=g); C c0..c3 at (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k16, bf16 operands, f32 accumulators.  A a0..a3 rows g,
// g+8, g, g+8 at columns 2t, 2t, 2t+8, 2t+8 (two elements each); B b0, b1
// rows 2t, 2t+8 (two each) at column g; C as above.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big keeps x's sign, exponent and top 10 mantissa bits,
// small is the exact remainder (the tensor core reads its top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b in 3xTF32: the two small terms first, then big * big.  An
// operand read from bf16 is exact in tf32 (its small part is 0): with
// A_EXACT or B_EXACT the product with that zero part is left out, which
// changes no bit of c.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  if constexpr (!A_EXACT) mma_tf32(c, as, bb0, bb1);
  if constexpr (!B_EXACT) mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void split4(const float v[4], uint32_t big[4],
                                       uint32_t small[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(v[q], big[q], small[q]);
}

// the inclusive prefix sum of v[0..Q) in place, by warp 0 (32 steps a pass)
__device__ __forceinline__ void warp_cumsum(float* v, int Q) {
  const int lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane;
    float s = i < Q ? v[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    s += carry;
    if (i < Q) v[i] = s;
    carry = __shfl_sync(0xffffffffu, s, 31);
  }
}

// ----------------------------------------- pass 1: chunk states from zero
// CTA (batch b, head h, chunk c), 8 warps.  Warp w owns state rows
// 16 (w % 4) .. +15 and NT n8 tiles of columns from 8 NT (w / 4) (NT = 8
// for N > 64, 4 below) over the chunk's Q steps, 64 rows a tile in a
// two-stage cp.async ring.  A = (x . w)^T with
// w_j = dt_j exp(cl - cum_j) applied as the fragment is loaded, B = the B
// rows (zero-padded to 16 NT columns).
static int state_ntiles(int N) { return N > 64 ? 8 : 4; }

static size_t chunk_state_smem(int P, int N, int Q, int xs, int bs) {
  const int P16 = round_up(P, 16), WB = 16 * state_ntiles(N);
  const int ldx = P16 + (xs == 4 ? 4 : 8), ldb = WB + (bs == 4 ? 4 : 8);
  return (size_t)2 * round_up(Q, SSD_T) * sizeof(float) +
         (size_t)2 * SSD_T * ((size_t)ldx * xs + (size_t)ldb * bs);
}

template <typename T, typename U, int NT>
__global__ void __launch_bounds__(SSD_STATE_THREADS, 2)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const U* __restrict__ Bm,
                float* __restrict__ cum_out, float* __restrict__ local,
                int S, int H, int P, int G, int N, int Q, int vec_x,
                int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WB = 16 * NT;
  const int nc = S / Q;
  int blk = blockIdx.x;
  const int c = blk % nc;
  blk /= nc;
  const int h = blk % H, b = blk / H;
  const int grp = h / (H / G);
  const int P16 = round_up(P, 16);
  const int QT = round_up(Q, SSD_T), tiles = QT / SSD_T;
  const int ldx = col_ld<T>(P16), ldb = col_ld<U>(WB);
  float* cum = reinterpret_cast<float*>(smem);  // QT
  float* w = cum + QT;                          // QT: dt_j exp(cl - cum_j)
  T* xs = reinterpret_cast<T*>(w + QT);         // 2 stages of SSD_T x ldx
  U* bs = reinterpret_cast<U*>(xs + 2 * SSD_T * ldx);  // 2 of SSD_T x ldb

  const size_t c0 = (size_t)c * Q, xrow = (size_t)H * P,
               brow = (size_t)G * N;
  const T* xb = x + ((size_t)b * S + c0) * xrow + (size_t)h * P;
  const U* Bb = Bm + ((size_t)b * S + c0) * brow + (size_t)grp * N;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // tile 0's copies fly while the scan runs
  load_tile(xs, ldx, xb, xrow, SSD_T, Q, P, P16, vec_x);
  load_tile(bs, ldb, Bb, brow, SSD_T, Q, N, WB, vec_b);
  cp_async_commit();

  const float a = A[h];
  for (int i = tid; i < QT; i += blockDim.x) {
    const float d = i < Q ? dtb[(size_t)i * H] : 0.f;
    cum[i] = d * a;
    w[i] = d;
  }
  __syncthreads();
  if (warp == 0) warp_cumsum(cum, Q);
  __syncthreads();
  const float cl = cum[Q - 1];
  float* cum_dst = cum_out + ((size_t)b * H + h) * S + c0;
  for (int i = tid; i < Q; i += blockDim.x) {
    w[i] *= expf(cl - cum[i]);
    cum_dst[i] = cum[i];
  }

  const int pm = warp & 3, n0 = (warp >> 2) * 8 * NT;
  const int p = pm * 16 + g;
  const bool rows_on = pm * 16 < P;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  for (int jt = 0; jt < tiles; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < tiles) {
      const int j1 = (jt + 1) * SSD_T;
      load_tile(xs + (st ^ 1) * SSD_T * ldx, ldx, xb + (size_t)j1 * xrow,
                xrow, SSD_T, Q - j1, P, P16, vec_x);
      load_tile(bs + (st ^ 1) * SSD_T * ldb, ldb, Bb + (size_t)j1 * brow,
                brow, SSD_T, Q - j1, N, WB, vec_b);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // tile jt (and, at jt = 0, w) is in
    if (rows_on) {
      const T* xt = xs + st * SSD_T * ldx;
      const U* bt = bs + st * SSD_T * ldb + n0 + g;
      const float* wt = w + jt * SSD_T;
#pragma unroll 2
      for (int kk = 0; kk < SSD_T / 8; ++kk) {
        const int r = kk * 8 + 2 * t;  // columns t, t + 4: steps r, r + 1
        const float w0 = wt[r], w1 = wt[r + 1];
        const float av[4] = {to_f32(xt[r * ldx + p]) * w0,
                             to_f32(xt[r * ldx + p + 8]) * w0,
                             to_f32(xt[(r + 1) * ldx + p]) * w1,
                             to_f32(xt[(r + 1) * ldx + p + 8]) * w1};
        uint32_t ab[4], as[4];
        split4(av, ab, as);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_3xtf32<false, sizeof(U) == 2>(
              acc[nt], ab, as, to_f32(bt[r * ldb + nt * 8]),
              to_f32(bt[(r + 1) * ldb + nt * 8]));
      }
    }
    __syncthreads();  // the stage is refilled next
  }

  if (!rows_on) return;
  float* out = local + (((size_t)b * H + h) * nc + c) * (size_t)P * N;
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = p + 8 * half;
      if (pr >= P || n >= N) continue;
      float* o = out + (size_t)pr * N + n;
      if (even) {
        store2(o, acc[nt][2 * half], acc[nt][2 * half + 1]);
      } else {
        o[0] = acc[nt][2 * half];
        if (n + 1 < N) o[1] = acc[nt][2 * half + 1];
      }
    }
  }
}

// ----------------------------------------------- pass 2: the state pass
// Thread e of a (batch, head) holds V state elements and walks the chunks
// in order: states[c] <- S (the state entering chunk c), then
// S <- S * exp(cl_c) + local_c, rounded as the reference rounds it (a
// product, then a sum).  Loads run four chunks ahead of the stores.
template <int V>
__global__ void __launch_bounds__(SSD_PASS_THREADS)
ssd_state_pass(float* states, const float* __restrict__ cum,
               float* __restrict__ final_state, int BH, int S, int Q,
               int PN) {
  const int per = PN / V;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)BH * per) return;
  const int bh = (int)(e / per), k = (int)(e - (long long)bh * per) * V;
  const int nc = S / Q;
  float* base = states + (size_t)bh * nc * PN + k;
  const float* cl = cum + (size_t)bh * S + Q - 1;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float loc[4][V], d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      const float* src = base + (size_t)(c0 + u) * PN;
      if constexpr (V == 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(src);
        loc[u][0] = l4.x, loc[u][1] = l4.y, loc[u][2] = l4.z,
        loc[u][3] = l4.w;
      } else {
        loc[u][0] = src[0];
      }
      d[u] = expf(cl[(size_t)(c0 + u) * Q]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u >= nc) break;
      float* dst = base + (size_t)(c0 + u) * PN;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
      } else {
        dst[0] = s[0];
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        s[v] = __fadd_rn(__fmul_rn(s[v], d[u]), loc[u][v]);
    }
  }
  float* fin = final_state + (size_t)bh * PN + k;
#pragma unroll
  for (int v = 0; v < V; ++v) fin[v] = s[v];
}

// --------------------------------------- pass 3: the scores, once a group
// CTA (batch b, group, chunk c, 64-row tile it), 4 warps; warp w owns rows
// 16w .. 16w + 15 of the tile and, for each column tile at or below it,
// eight n8 tiles of C B^T.  Products of the stored types: 3xTF32 for f32,
// m16n8k16 for bf16.
template <typename U>
struct Scores;

template <>
struct Scores<float> {
  // acc[jn] += C rows (16 from c_rows) . B rows jn*8 .. +7 of b_tile
  static __device__ __forceinline__ void run(float acc[8][4],
                                             const float* c_rows,
                                             const float* b_tile, int ld,
                                             int N16, int g, int t) {
    for (int k0 = 0; k0 < N16; k0 += 8) {
      const float2 lo = pair_f32(c_rows + g * ld + k0 + 2 * t);
      const float2 hi = pair_f32(c_rows + (g + 8) * ld + k0 + 2 * t);
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
struct Scores<bf16> {
  static __device__ __forceinline__ void run(float acc[8][4],
                                             const bf16* c_rows,
                                             const bf16* b_tile, int ld,
                                             int N16, int g, int t) {
    auto word = [](const bf16* p) {
      return *reinterpret_cast<const uint32_t*>(p);
    };
    for (int k0 = 0; k0 < N16; k0 += 16) {
      const uint32_t a[4] = {word(c_rows + g * ld + k0 + 2 * t),
                             word(c_rows + (g + 8) * ld + k0 + 2 * t),
                             word(c_rows + g * ld + k0 + 8 + 2 * t),
                             word(c_rows + (g + 8) * ld + k0 + 8 + 2 * t)};
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const bf16* br = b_tile + (jn * 8 + g) * ld + k0 + 2 * t;
        mma_bf16(acc[jn], a, word(br), word(br + 8));
      }
    }
  }
};

static size_t chunk_cb_smem(int N, int bs) {
  return (size_t)2 * SSD_T * pair_ld(round_up(N, 16)) * bs;
}

template <typename U>
__global__ void __launch_bounds__(SSD_TILE_THREADS)
ssd_chunk_cb(const U* __restrict__ Bm, const U* __restrict__ Cm,
             float* __restrict__ cb, int S, int G, int N, int Q, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = S / Q, row_tiles = (Q + SSD_T - 1) / SSD_T;
  int blk = blockIdx.x;
  const int it = blk % row_tiles;
  blk /= row_tiles;
  const int c = blk % nc;
  blk /= nc;
  const int grp = blk % G, b = blk / G;
  const int N16 = round_up(N, 16), ld = pair_ld(N16);
  U* cs = reinterpret_cast<U*>(smem);  // SSD_T x ld: the tile's C rows
  U* bs = cs + SSD_T * ld;             // SSD_T x ld: a column tile's B rows
  const size_t brow = (size_t)G * N;
  const size_t first = ((size_t)b * S + (size_t)c * Q) * brow +
                       (size_t)grp * N;
  const int i0 = it * SSD_T;
  float* out = cb + (((size_t)b * G + grp) * nc + c) * (size_t)Q * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i = i0 + 16 * warp + g;
  const bool even = (Q & 1) == 0;

  load_tile(cs, ld, Cm + first + (size_t)i0 * brow, brow, SSD_T, Q - i0, N,
            N16, vec);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * SSD_T;
    load_tile(bs, ld, Bm + first + (size_t)j0 * brow, brow, SSD_T, Q - j0,
              N, N16, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[jn][q] = 0.f;
    Scores<U>::run(acc, cs + 16 * warp * ld, bs, ld, N16, g, t);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int j = j0 + jn * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ir = i + 8 * half;
        if (ir >= Q || j >= Q) continue;
        float* o = out + (size_t)ir * Q + j;
        if (even) {
          store2(o, acc[jn][2 * half], acc[jn][2 * half + 1]);
        } else {
          o[0] = acc[jn][2 * half];
          if (j + 1 < Q) o[1] = acc[jn][2 * half + 1];
        }
      }
    }
    __syncthreads();  // bs is refilled next
  }
}

// ------------------------------------------------ pass 4: chunk outputs
// CTA (batch b, head h, chunk c, 64-row tile it; the grid runs a chunk's
// heaviest tile first), 4 warps; warp w owns rows 16w .. 16w + 15 of the
// tile and a 16 x P block of y in eight n8 tiles of f32 accumulators.
// What a warp alone reads (its rows of C and of the scores) goes from global
// memory (L2) straight into A fragments, a step ahead of its use; what the
// four warps share is staged in one shared region: first the entering state
// for y_off = exp(cum_i) (C state^T), then a two-stage cp.async ring of the
// x rows of each column tile at or below the diagonal, for
// (s_ij exp(cum_i - cum_j) dt_j) x_j with the masked score formed in
// registers.  The state and the x rows are zero-padded to 64 columns of
// p, so that every warp runs all eight n8 tiles without a branch.
static size_t chunk_scan_smem(int N, int Q, int xs) {
  const int N16 = round_up(N, 16);
  const size_t state = (size_t)SSD_MAX_P * pair_ld(N16) * sizeof(float);
  const size_t ring =
      (size_t)2 * SSD_T * (SSD_MAX_P + (xs == 4 ? 4 : 8)) * xs;
  return (size_t)2 * round_up(Q, SSD_T) * sizeof(float) +
         (state > ring ? state : ring);
}

// (row[k], row[k + 1]) as f32, 0 past `width` or where !in; with `pairs`
// (width even, rows 8-byte aligned) as one load
template <typename E>
__device__ __forceinline__ float2 ld_pair(const E* row, int k, int width,
                                          bool in, bool pairs) {
  if (!in) return make_float2(0.f, 0.f);
  if (pairs) return k < width ? pair_f32(row + k) : make_float2(0.f, 0.f);
  return make_float2(k < width ? to_f32(row[k]) : 0.f,
                     k + 1 < width ? to_f32(row[k + 1]) : 0.f);
}

template <typename T, typename U>
__global__ void __launch_bounds__(SSD_TILE_THREADS)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const U* __restrict__ Cm, const float* __restrict__ cum_in,
               const float* __restrict__ cb,
               const float* __restrict__ states, T* __restrict__ y, int S,
               int H, int P, int G, int N, int Q, int vec_x, int vec_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = S / Q, row_tiles = (Q + SSD_T - 1) / SSD_T;
  int blk = blockIdx.x;
  const int it = row_tiles - 1 - blk % row_tiles;
  blk /= row_tiles;
  const int c = blk % nc;
  blk /= nc;
  const int h = blk % H, b = blk / H;
  const int grp = h / (H / G);
  const int N16 = round_up(N, 16);
  const int QT = round_up(Q, SSD_T);
  const int ldx = col_ld<T>(SSD_MAX_P), lds = pair_ld(N16);
  float* cum = reinterpret_cast<float*>(smem);  // QT
  float* dts = cum + QT;                        // QT
  // the shared region: the state (64 x lds), then the ring of x rows
  float* ss = dts + QT;
  T* ring = reinterpret_cast<T*>(ss);  // 2 stages of SSD_T x ldx

  const size_t c0 = (size_t)c * Q, xrow = (size_t)H * P,
               brow = (size_t)G * N;
  const T* xb = x + ((size_t)b * S + c0) * xrow + (size_t)h * P;
  T* yb = y + ((size_t)b * S + c0) * xrow + (size_t)h * P;
  const float* dtb = dt + ((size_t)b * S + c0) * H + h;
  const float* cumb = cum_in + ((size_t)b * H + h) * S + c0;
  const float* sb = states + (((size_t)b * H + h) * nc + c) * (size_t)P * N;
  const int i0 = it * SSD_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = 16 * warp + g;  // the lane's rows r and r + 8 of the tile
  const int i_lo = i0 + r, i_hi = i_lo + 8;
  const bool in_lo = i_lo < Q, in_hi = i_hi < Q;
  // the lane's rows of C and of the chunk's scores
  const U* c_lo = Cm + ((size_t)b * S + c0 + i_lo) * brow + (size_t)grp * N;
  const U* c_hi = c_lo + 8 * brow;
  const float* cbb = cb + (((size_t)b * G + grp) * nc + c) * (size_t)Q * Q;
  const float* s_lo_row = cbb + (size_t)i_lo * Q;
  const float* s_hi_row = s_lo_row + 8 * (size_t)Q;
  const bool pairs_n = (N & 1) == 0, pairs_q = (Q & 1) == 0;

  load_tile(ss, lds, sb, (size_t)N, SSD_MAX_P, P, N, N16, vec_s);
  cp_async_commit();
  for (int i = threadIdx.x; i < i0 + SSD_T; i += blockDim.x) {
    cum[i] = i < Q ? cumb[i] : 0.f;
    dts[i] = i < Q ? dtb[(size_t)i * H] : 0.f;
  }
  float acc[8][4];
#pragma unroll
  for (int pt = 0; pt < 8; ++pt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[pt][q] = 0.f;
  float2 a_lo = ld_pair(c_lo, 2 * t, N, in_lo, pairs_n);
  float2 a_hi = ld_pair(c_hi, 2 * t, N, in_hi, pairs_n);
  cp_async_wait_all();
  __syncthreads();

  // y_off = exp(cum_i) * (C_i . state), the state entering the chunk
  for (int k0 = 0; k0 < N16; k0 += 8) {
    const float av[4] = {a_lo.x, a_hi.x, a_lo.y, a_hi.y};
    if (k0 + 8 < N16) {
      a_lo = ld_pair(c_lo, k0 + 8 + 2 * t, N, in_lo, pairs_n);
      a_hi = ld_pair(c_hi, k0 + 8 + 2 * t, N, in_hi, pairs_n);
    }
    uint32_t ab[4], as[4];
    split4(av, ab, as);
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const float2 sv = pair_f32(ss + (pt * 8 + g) * lds + k0 + 2 * t);
      mma_3xtf32<sizeof(U) == 2, false>(acc[pt], ab, as, sv.x, sv.y);
    }
  }
  const float ci_lo = cum[i_lo], ci_hi = cum[i_hi];
  {
    const float e_lo = in_lo ? expf(ci_lo) : 0.f;
    const float e_hi = in_hi ? expf(ci_hi) : 0.f;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      acc[pt][0] *= e_lo, acc[pt][1] *= e_lo;
      acc[pt][2] *= e_hi, acc[pt][3] *= e_hi;
    }
  }
  __syncthreads();  // the ring takes the state's place

  // y_diag over the column tiles jt <= it
  auto issue = [&](int jt) {
    const int j0 = jt * SSD_T;
    load_tile(ring + (jt & 1) * SSD_T * ldx, ldx, xb + (size_t)j0 * xrow,
              xrow, SSD_T, Q - j0, P, SSD_MAX_P, vec_x);
  };
  issue(0);
  cp_async_commit();
  const int last = i0 + 16 * warp + 15;  // the warp's last row
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) issue(jt + 1);
    cp_async_commit();
    const int jbase = jt * SSD_T;
    // steps of 8 columns up to the warp's last row (8 below the diagonal)
    const int steps = min(SSD_T / 8, (last - jbase) / 8 + 1);
    float2 s_lo = ld_pair(s_lo_row, jbase + 2 * t, Q, in_lo, pairs_q);
    float2 s_hi = ld_pair(s_hi_row, jbase + 2 * t, Q, in_hi, pairs_q);
    cp_async_wait_prior();
    __syncthreads();
    const T* xt = ring + (jt & 1) * SSD_T * ldx;
    for (int kk = 0; kk < steps; ++kk) {
      const int ja = jbase + kk * 8 + 2 * t, jb = ja + 1;
      const float2 sl = s_lo, sh = s_hi;
      if (kk + 1 < steps) {
        s_lo = ld_pair(s_lo_row, ja + 8, Q, in_lo, pairs_q);
        s_hi = ld_pair(s_hi_row, ja + 8, Q, in_hi, pairs_q);
      }
      const float cja = cum[ja], cjb = cum[jb], dja = dts[ja],
                  djb = dts[jb];
      // exp only where j <= i (and i < Q): above the diagonal it may
      // overflow, and inf * 0 is NaN
      const float av[4] = {
          ja <= i_lo && in_lo ? sl.x * __expf(ci_lo - cja) * dja : 0.f,
          ja <= i_hi && in_hi ? sh.x * __expf(ci_hi - cja) * dja : 0.f,
          jb <= i_lo && in_lo ? sl.y * __expf(ci_lo - cjb) * djb : 0.f,
          jb <= i_hi && in_hi ? sh.y * __expf(ci_hi - cjb) * djb : 0.f};
      uint32_t ab[4], as[4];
      split4(av, ab, as);
      const int kr = kk * 8 + 2 * t;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const int pc = pt * 8 + g;
        mma_3xtf32<false, sizeof(T) == 2>(acc[pt], ab, as,
                                          to_f32(xt[kr * ldx + pc]),
                                          to_f32(xt[(kr + 1) * ldx + pc]));
      }
    }
    __syncthreads();  // the stage is refilled next
  }

  const bool even = (P & 1) == 0;
#pragma unroll
  for (int pt = 0; pt < 8; ++pt) {
    const int pc = pt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? i_hi : i_lo;
      if (i >= Q || pc >= P) continue;
      T* o = yb + (size_t)i * xrow + pc;
      if (even) {
        store2(o, acc[pt][2 * half], acc[pt][2 * half + 1]);
      } else {
        o[0] = from_f32<T>(acc[pt][2 * half]);
        if (pc + 1 < P) o[1] = from_f32<T>(acc[pt][2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ launches
// Calls f(T{}, U{}) with x's type T and B and C's type U (codes: 0 f32,
// 1 bf16).
template <typename F>
static int by_dtypes(int x_dtype, int bc_dtype, F f) {
  if (x_dtype == 0 && bc_dtype == 0) return f(float{}, float{});
  if (x_dtype == 0) return f(float{}, bf16{});
  if (bc_dtype == 0) return f(bf16{}, float{});
  return f(bf16{}, bf16{});
}

static cudaError_t allow(const void* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SSD_MAX_SMEM);
}

// Lets every instance take SSD_MAX_SMEM bytes of dynamic shared memory, once
// a device (a bit a device in `ready`; threads that race set the same
// values).
static cudaError_t allow_smem() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (ready.load() & bit) return cudaSuccess;
  const void* kernels[] = {
      (const void*)ssd_chunk_state<float, float, 8>,
      (const void*)ssd_chunk_state<float, bf16, 8>,
      (const void*)ssd_chunk_state<bf16, float, 8>,
      (const void*)ssd_chunk_state<bf16, bf16, 8>,
      (const void*)ssd_chunk_state<float, float, 4>,
      (const void*)ssd_chunk_state<float, bf16, 4>,
      (const void*)ssd_chunk_state<bf16, float, 4>,
      (const void*)ssd_chunk_state<bf16, bf16, 4>,
      (const void*)ssd_chunk_scan<float, float>,
      (const void*)ssd_chunk_scan<float, bf16>,
      (const void*)ssd_chunk_scan<bf16, float>,
      (const void*)ssd_chunk_scan<bf16, bf16>,
      (const void*)ssd_chunk_cb<float>,
      (const void*)ssd_chunk_cb<bf16>};
  for (const void* kernel : kernels) {
    err = allow(kernel);
    if (err != cudaSuccess) return err;
  }
  ready.fetch_or(bit);
  return cudaSuccess;
}

// rows of `width` elements of `es` bytes, `stride` elements apart from `p`,
// can be copied 16 bytes at a time
static int vec16(const void* p, long long width, long long stride, int es) {
  return (uintptr_t)p % 16 == 0 && width * es % 16 == 0 &&
         stride * es % 16 == 0;
}

extern "C" int ssd_scan_max_p(void) { return SSD_MAX_P; }
extern "C" int ssd_scan_max_n(void) { return SSD_MAX_N; }
// 1 where every pass's shared memory fits a CTA for (P, N, Q) in f32, the
// widest case
extern "C" int ssd_scan_fits(int P, int N, int Q) {
  return chunk_state_smem(P, N, Q, 4, 4) <= SSD_MAX_SMEM &&
         chunk_scan_smem(N, Q, 4) <= SSD_MAX_SMEM &&
         chunk_cb_smem(N, 4) <= SSD_MAX_SMEM;
}

static bool valid(int b, int S, int H, int P, int G, int N, int Q,
                  int x_dtype, int bc_dtype) {
  return b >= 0 && S >= 0 && P >= 1 && P <= SSD_MAX_P && N >= 1 &&
         N <= SSD_MAX_N && G >= 1 && H >= G && H % G == 0 && Q >= 1 &&
         S % Q == 0 && ssd_scan_fits(P, N, Q) &&
         (x_dtype == 0 || x_dtype == 1) && (bc_dtype == 0 || bc_dtype == 1);
}

// x: (b, S, H, P); dt: (b, S, H) f32; A: (H,) f32; B: (b, S, G, N).
// Writes cum (b, H, S) f32 and local (b, H, S / Q, P, N) f32.
extern "C" int ssd_chunk_state_launch(const void* x, const void* dt,
                                      const void* A, const void* B,
                                      void* cum, void* local, int b, int S,
                                      int H, int P, int G, int N, int Q,
                                      int x_dtype, int bc_dtype,
                                      void* stream) {
  if (!valid(b, S, H, P, G, N, Q, x_dtype, bc_dtype))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || S == 0) return 0;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)b * H * (S / Q));
  return by_dtypes(x_dtype, bc_dtype, [&](auto tx, auto tu) {
    using T = decltype(tx);
    using U = decltype(tu);
    const size_t smem = chunk_state_smem(P, N, Q, sizeof(T), sizeof(U));
    const int vx = vec16(x, P, (long long)H * P, sizeof(T));
    const int vb = vec16(B, N, (long long)G * N, sizeof(U));
    if (state_ntiles(N) == 8)
      ssd_chunk_state<T, U, 8><<<blocks, SSD_STATE_THREADS, smem,
                                 (cudaStream_t)stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const U*)B,
          (float*)cum, (float*)local, S, H, P, G, N, Q, vx, vb);
    else
      ssd_chunk_state<T, U, 4><<<blocks, SSD_STATE_THREADS, smem,
                                 (cudaStream_t)stream>>>(
          (const T*)x, (const float*)dt, (const float*)A, (const U*)B,
          (float*)cum, (float*)local, S, H, P, G, N, Q, vx, vb);
    return (int)cudaGetLastError();
  });
}

// states: (BH, S / Q, P*N) f32, the chunks' own states, overwritten with
// the state entering each chunk; cum: (BH, S) f32; final: (BH, P*N) f32.
extern "C" int ssd_state_pass_launch(void* states, const void* cum,
                                     void* final_state, int BH, int S,
                                     int Q, int PN, void* stream) {
  if (BH < 0 || S < 0 || PN < 1 || Q < 1 || S % Q)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  const bool v4 = PN % 4 == 0 && (uintptr_t)states % 16 == 0;
  const long long threads = (long long)BH * (v4 ? PN / 4 : PN);
  const unsigned blocks =
      (unsigned)((threads + SSD_PASS_THREADS - 1) / SSD_PASS_THREADS);
  if (v4)
    ssd_state_pass<4><<<blocks, SSD_PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)states, (const float*)cum, (float*)final_state, BH, S, Q, PN);
  else
    ssd_state_pass<1><<<blocks, SSD_PASS_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)states, (const float*)cum, (float*)final_state, BH, S, Q, PN);
  return (int)cudaGetLastError();
}

// B, C: (b, S, G, N); cb: (b, G, S / Q, Q, Q) f32, written at j <= i (and
// at the other entries of the 64 x 64 tiles on the diagonal).
extern "C" int ssd_chunk_cb_launch(const void* B, const void* C, void* cb,
                                   int b, int S, int G, int N, int Q,
                                   int bc_dtype, void* stream) {
  if (!valid(b, S, G, 1, G, N, Q, 0, bc_dtype))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || S == 0) return 0;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((long long)b * G * (S / Q) * ((Q + SSD_T - 1) / SSD_T));
  return by_dtypes(0, bc_dtype, [&](auto, auto tu) {
    using U = decltype(tu);
    const int vec = vec16(B, N, (long long)G * N, sizeof(U)) &&
                    vec16(C, N, (long long)G * N, sizeof(U));
    ssd_chunk_cb<U><<<blocks, SSD_TILE_THREADS,
                      chunk_cb_smem(N, sizeof(U)), (cudaStream_t)stream>>>(
        (const U*)B, (const U*)C, (float*)cb, S, G, N, Q, vec);
    return (int)cudaGetLastError();
  });
}

// x, y: (b, S, H, P); dt: (b, S, H) f32; C: (b, S, G, N); cum: (b, H, S);
// cb: (b, G, S / Q, Q, Q); states: (b, H, S / Q, P, N), entering each chunk.
extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt,
                                     const void* C, const void* cum,
                                     const void* cb, const void* states,
                                     void* y, int b, int S, int H, int P,
                                     int G, int N, int Q, int x_dtype,
                                     int bc_dtype, void* stream) {
  if (!valid(b, S, H, P, G, N, Q, x_dtype, bc_dtype))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || S == 0) return 0;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks =
      (unsigned)((long long)b * H * (S / Q) * ((Q + SSD_T - 1) / SSD_T));
  // a state's rows start 16-byte aligned where N is a multiple of 4
  const int vec_s = (uintptr_t)states % 16 == 0 && N % 4 == 0;
  return by_dtypes(x_dtype, bc_dtype, [&](auto tx, auto tu) {
    using T = decltype(tx);
    using U = decltype(tu);
    ssd_chunk_scan<T, U><<<blocks, SSD_TILE_THREADS,
                           chunk_scan_smem(N, Q, sizeof(T)),
                           (cudaStream_t)stream>>>(
        (const T*)x, (const float*)dt, (const U*)C, (const float*)cum,
        (const float*)cb, (const float*)states, (T*)y, S, H, P, G, N, Q,
        vec16(x, P, (long long)H * P, sizeof(T)), vec_s);
    return (int)cudaGetLastError();
  });
}

// The whole call: the four passes back to back on `stream`.  Scratch from
// the caller: cum (b, H, S), states (b, H, S / Q, P, N) and cb
// (b, G, S / Q, Q, Q), all f32; y (b, S, H, P) in x's dtype, final state
// (b, H, P, N) f32.  Dtype codes: 0 f32, 1 bf16.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* final_state, void* cum, void* states,
                               void* cb, int b, int S, int H, int P, int G,
                               int N, int Q, int x_dtype, int bc_dtype,
                               void* stream) {
  int err = ssd_chunk_state_launch(x, dt, A, B, cum, states, b, S, H, P, G,
                                   N, Q, x_dtype, bc_dtype, stream);
  if (err) return err;
  err = ssd_state_pass_launch(states, cum, final_state, b * H, S, Q, P * N,
                              stream);
  if (err) return err;
  err = ssd_chunk_cb_launch(B, C, cb, b, S, G, N, Q, bc_dtype, stream);
  if (err) return err;
  return ssd_chunk_scan_launch(x, dt, C, cum, cb, states, y, b, S, H, P, G,
                               N, Q, x_dtype, bc_dtype, stream);
}
