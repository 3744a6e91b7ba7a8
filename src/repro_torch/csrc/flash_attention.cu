// Flash attention forward: online-softmax attention, causal or
// bidirectional, with grouped-query heads, on the tensor cores.
//
// Replaces the TPU kernel `_flash_kernel` (the `pl.pallas_call` of
// `flash_attention_fwd`) in src/repro/kernels/flash_attention.py, with its
// semantics kept exactly: scores s = (q . k) * D^-0.5 accumulated in f32;
// causal positions aligned top-left from 0 (query i sees keys j <= i, also
// when Sq != Sk) and masked with NEG_INF = -1e30, never -inf (exp(-inf -
// -inf) is NaN); per query row a running max m, sum l and accumulator
// acc[D], updated per key tile as m' = max(m, max s), alpha = exp(m - m'),
// p = exp(s - m'), l' = l * alpha + sum p, acc' = acc * alpha + p v; keys
// past Sk contribute exactly 0; out = acc / (l == 0 ? 1 : l), rounded to
// nearest into the inputs' dtype.  A key tile is skipped only where it lies
// wholly above the diagonal (for a warp's 16 rows: every pair it would add
// is masked, and key 0, which every row sees, comes first, so the skipped
// tile would have added exactly 0).  Flat head bh = b * Hq + h reads KV head
// b * Hkv + h / (Hq / Hkv).
//
// What bounds it on this card: operations, 4 * D FLOP per computed
// query/key pair (at SmolLM-360M's geometry, 4096 tokens, ~1,500 FLOP a
// byte of q, k, v and out), so the products belong on the tensor cores.
// Design (FlashAttention-2's forward, with mma.sync):
// * One CTA of 4 warps per (64-query tile, flat head); the grid runs every
//   head's heaviest causal tile first.  Warp w owns query rows 16w..16w+15
//   and holds them in registers for the whole key loop as MMA A fragments,
//   loaded once from global memory.
// * K and V tiles stream through a two-stage ring in dynamic shared memory,
//   fed by 16-byte cp.async copies: the copy of tile j+1 is in flight while
//   the warps compute on tile j.  Rows past Sk are zero-filled by the copy.
//   Rows are padded by 16 (bf16 K, V; f32 K) or 8 bytes (f32 V) so that
//   the fragment loads of 8 rows hit distinct banks.
// * bf16: S = Q K^T and O += P V with mma.m16n8k16 (bf16 operands, f32
//   accumulators); K fragments by ldmatrix, V fragments by ldmatrix.trans.
//   S stays in registers: a row's max and sum are reduced over its quad
//   with shuffles, and two n8 accumulator tiles of P are the k16 A
//   fragment of P V, so P never goes to shared memory.  64-key tiles.  P
//   rounded to bf16 (as F.scaled_dot_product_attention rounds it) put the
//   full-width check at 0.91-1.32 of its limit (atol 1e-3, rtol 2e-2) on
//   an H100, so P is split into bf16 big + small and P V takes two MMAs:
//   P keeps 16 bits, and the f32 reference's P is matched to ~2^-17.
// * f32: plain TF32 keeps 10 mantissa bits, too few for 2e-5, so every
//   product is 3xTF32 with mma.m16n8k8 (x = big + small, big = tf32(x),
//   small = tf32(x - big); small*big + big*small + big*big).  The k index
//   of each 8-deep step is permuted (fragment column t holds element 2t,
//   column t + 4 element 2t + 1) so that Q, K and P fragments are read as
//   the pairs the accumulator layout already holds: P goes from S's
//   accumulators to P V's A fragment without a shuffle.  32-key tiles keep
//   the f32 ring at 68 KB for D = 128.
// * D is a template parameter, instantiated at 64, 80, 96 and 128 (the
//   configs' head dims); flash_attention_head_dim names the instance a D
//   runs at, and the wrapper zero-pads q, k and v to it (scale from the
//   true D) and drops the extra output columns.
//
// q, k, v and out are all f32 or all bf16, contiguous and 16-byte aligned.
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_WARPS 4
#define FA_THREADS (32 * FA_WARPS)
#define FA_BQ (16 * FA_WARPS)  // query rows a CTA owns, 16 a warp
#define FA_MAX_D 128
#define FA_NEG_INF (-1e30f)
#define FA_FULL 0xffffffffu

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ PTX wrappers
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a * b, m16n8k16, bf16 operands, f32 accumulators.  Fragments (PTX
// ISA; g = lane / 4, t = lane % 4): A a0..a3 rows g, g+8, g, g+8 at columns
// 2t, 2t, 2t+8, 2t+8 (two elements each); B b0, b1 rows 2t, 2t+8 (two
// each) at column g; C c0..c3 at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b, m16n8k8, tf32 operands.  Fragments: A a0..a3 at (g, t),
// (g+8, t), (g, t+4), (g+8, t+4); B b0, b1 at (k=t, n=g), (k=t+4, n=g);
// C as above.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the multi-function unit alone: relative error ~2^-22, and results
// below 2^-126 flush to 0 (a row's largest p is 1, so its f32 sum cannot
// hold them anyway).  exp2f adds range fix-ups to every score, and issue in
// the softmax is what binds the bf16 kernel.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a tf32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a * b in 3xTF32: the two small terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0,
                                           uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// (lo, hi) = big + small, each packed as two bf16 (lo in the low half):
// big = bf16(x), small = bf16(x - big), 16 bits of x's mantissa between them
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& small) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  __nv_bfloat162 s = __floats2bfloat162_rn(lo - __low2float(b),
                                           hi - __high2float(b));
  big = *reinterpret_cast<uint32_t*>(&b);
  small = *reinterpret_cast<uint32_t*>(&s);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------- one warp's products
// Warp<T, D>: the tile shapes of dtype T, the warp's query fragments and
// its two products on one key tile (S = Q K^T into s, O += P V from s).
template <typename T, int D>
struct Warp;

template <int D>
struct Warp<bf16, D> {
  static constexpr int BK = 64, LDK = D + 8, LDV = D + 8;
  // CTAs an SM should hold (caps registers at 128, 168 and 255 a thread)
  static constexpr int MIN_CTAS = D <= 64 ? 4 : D <= 96 ? 3 : 2;
  uint32_t q[D / 16][4];  // A fragments, one per 16-deep k-step

  __device__ __forceinline__ void load_q(const bf16* qp, int row0, int Sq,
                                         int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + 8 * (i & 1);
        const int c = kk * 16 + 8 * (i >> 1) + 2 * t;
        q[kk][i] = r < Sq ? *reinterpret_cast<const uint32_t*>(
                                qp + (size_t)r * D + c)
                          : 0u;
      }
  }

  __device__ __forceinline__ void scores(float s[BK / 8][4], const bf16* ks,
                                         int lane) const {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    // ldmatrix.x4 lanes 0-7, 8-15, 16-23, 24-31 address the 8x8 blocks
    // (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15): b0, b1 of
    // n-tile 2np, then of 2np + 1
    const bf16* base =
        ks + ((lane & 7) + (lane >> 4) * 8) * LDK + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, base + np * 16 * LDK + kk * 16);
        mma_bf16(s[2 * np], q[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], q[kk], b[2], b[3]);
      }
  }

  __device__ __forceinline__ void pv(float o[D / 8][4],
                                     const float p[BK / 8][4],
                                     const bf16* vs, int lane) const {
    // ldmatrix.x4.trans blocks (keys 0-7, d 0-7), (8-15, 0-7), (0-7,
    // 8-15), (8-15, 8-15): b0, b1 of d n-tile 2dp, then of 2dp + 1
    const bf16* base =
        vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // n-tiles 2kk and 2kk + 1 of S are the k16 A fragment of keys
      // 16kk..16kk+15, as p = big + small, two bf16 values each
      const float x[8] = {p[2 * kk][0],     p[2 * kk][1],
                          p[2 * kk][2],     p[2 * kk][3],
                          p[2 * kk + 1][0], p[2 * kk + 1][1],
                          p[2 * kk + 1][2], p[2 * kk + 1][3]};
      uint32_t big[4], small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_bf16(x[2 * i], x[2 * i + 1], big[i],
                                             small[i]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, base + kk * 16 * LDV + dp * 16);
        mma_bf16(o[2 * dp], small, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], small, b[2], b[3]);
        mma_bf16(o[2 * dp], big, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], big, b[2], b[3]);
      }
    }
  }
};

template <int D>
struct Warp<float, D> {
  static constexpr int BK = 32, LDK = D + 8, LDV = D + 4;
  static constexpr int MIN_CTAS = 1;
  // per 8-deep k-step, with column t <-> d 2t and t + 4 <-> d 2t + 1:
  // q[kk] = {Q[g][2t], Q[g+8][2t], Q[g][2t+1], Q[g+8][2t+1]} (+ 8 kk)
  float q[D / 8][4];

  __device__ __forceinline__ void load_q(const float* qp, int row0, int Sq,
                                         int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + g + 8 * h;
        const float2 v = r < Sq ? *reinterpret_cast<const float2*>(
                                      qp + (size_t)r * D + kk * 8 + 2 * t)
                                : make_float2(0.f, 0.f);
        q[kk][h] = v.x;
        q[kk][2 + h] = v.y;
      }
  }

  __device__ __forceinline__ void scores(float s[BK / 8][4], const float* ks,
                                         int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(q[kk][i], ab[i], as[i]);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        // b0, b1 = K[key 8nt + g][d 8kk + 2t], [.. + 1]
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (nt * 8 + g) * LDK + kk * 8 + 2 * t);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
        mma_3xtf32(s[nt], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }

  __device__ __forceinline__ void pv(float o[D / 8][4],
                                     const float p[BK / 8][4],
                                     const float* vs, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      // keys 8kk + 2t and 8kk + 2t + 1 at columns t and t + 4: the A
      // fragment is S's accumulators of n-tile kk, reordered
      const float a[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
      const float* vrow = vs + (kk * 8 + 2 * t) * LDV + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(vrow[nt * 8], bb0, bs0);
        split_tf32(vrow[nt * 8 + LDV], bb1, bs1);
        mma_3xtf32(o[nt], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
};

// ------------------------------------------------------------ the kernel
// Issue the copies of one K/V tile (rows k0.. of this KV head) into a ring
// stage; rows at or past Sk are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* kp,
                                        const T* vp, int k0, int Sk,
                                        int tid) {
  using W = Warp<T, D>;
  constexpr int VPC = 16 / sizeof(T);  // elements in a 16-byte copy
  constexpr int CPR = D / VPC;         // copies a row
  static_assert((W::BK * CPR) % FA_THREADS == 0, "uneven tile copy");
#pragma unroll
  for (int it = 0; it < W::BK * CPR / FA_THREADS; ++it) {
    const int i = tid + it * FA_THREADS;
    const int r = i / CPR, c = (i - r * CPR) * VPC;
    const bool in = k0 + r < Sk;
    const size_t src = (size_t)(in ? k0 + r : 0) * D + c;
    cp_async16(ks + r * W::LDK + c, kp + src, in);
    cp_async16(vs + r * W::LDV + c, vp + src, in);
  }
}

// The online-softmax step on one tile's scores, in place: s becomes p.
// Scores and the running max are kept in base-2 units, s * scale * log2(e),
// so that p = exp2(x - m) = exp(s * scale - m') is one FADD and one EX2.
// Row h of the lane is row0 + g + 8h; l is the lane's part of the row sum
// (its quad's four parts are added at the end).  Only an edge tile (keys
// past Sk, or causal pairs above the diagonal) needs the masks.
template <int NT, int ND>
__device__ __forceinline__ void softmax_step(float s[NT][4], float o[ND][4],
                                             float m[2], float l[2],
                                             int row0, int g, int t, int k0,
                                             int Sk, float scale2, bool edge,
                                             bool causal) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    float mx = FA_NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[nt][2 * h + e] * scale2;
        const int col = k0 + nt * 8 + 2 * t + e;
        if (edge && causal && row < col) x = FA_NEG_INF;
        if (!edge || col < Sk) mx = fmaxf(mx, x);
        s[nt][2 * h + e] = x;
      }
    mx = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float alpha = ex2(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t + e;
        const float p =
            !edge || col < Sk ? ex2(s[nt][2 * h + e] - m_new) : 0.f;
        s[nt][2 * h + e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha + sum;
    m[h] = m_new;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][2 * h] *= alpha;
      o[nd][2 * h + 1] *= alpha;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, Warp<T, D>::MIN_CTAS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int Sq, int Sk, float scale, int causal) {
  using W = Warp<T, D>;
  constexpr int BK = W::BK;
  constexpr int STAGE = BK * (W::LDK + W::LDV);  // elements of K + V
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* smem = reinterpret_cast<T*>(fa_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;  // heavy tiles first
  const int row0 = q0 + 16 * warp;  // the warp's first query row
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)kvh * Sk * D;
  const T* vp = v + (size_t)kvh * Sk * D;

  // causal: tiles from k0 = q0 + FA_BQ on lie wholly above the diagonal
  const int kend = causal ? min(Sk, q0 + FA_BQ) : Sk;
  const int ntiles = (kend + BK - 1) / BK;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  if (ntiles > 0) load_kv<T, D>(smem, smem + BK * W::LDK, kp, vp, 0, Sk, tid);
  cp_async_commit();

  W w;
  w.load_q(qp, row0, Sq, g, t);
  float o[D / 8][4], m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    const T* ks = smem + (j & 1) * STAGE;
    if (j + 1 < ntiles) {
      T* next = smem + ((j + 1) & 1) * STAGE;
      load_kv<T, D>(next, next + BK * W::LDK, kp, vp, k0 + BK, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait_prior();  // tile j has landed, for this thread's copies
    __syncthreads();        // ... and for every thread's
    // the warp skips a tile wholly above the diagonal for its own rows
    if (!causal || k0 <= row0 + 15) {
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > row0);
      float s[BK / 8][4];
      w.scores(s, ks, lane);
      softmax_step<BK / 8, D / 8>(s, o, m, l, row0, g, t, k0, Sk, scale2,
                                  edge, causal);
      w.pv(o, s, ks + BK * W::LDK, lane);
    }
    __syncthreads();  // every warp is done with stage j & 1
  }

  T* op = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(FA_FULL, den, 1);
    den += __shfl_xor_sync(FA_FULL, den, 2);
    if (den == 0.f) den = 1.f;
    const int row = row0 + g + 8 * h;
    if (row >= Sq) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(op + (size_t)row * D + nd * 8 + 2 * t, o[nd][2 * h] / den,
             o[nd][2 * h + 1] / den);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                  int causal, cudaStream_t stream) {
  using W = Warp<T, D>;
  constexpr size_t smem = 2 * sizeof(T) * W::BK * (W::LDK + W::LDV);
  static_assert(smem <= 227 * 1024, "K/V ring above the shared memory");
  const int qtiles = (Sq + FA_BQ - 1) / FA_BQ;
  if (qtiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, qtiles);
  flash_fwd_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, scale,
      causal);
  return (int)cudaGetLastError();
}

// the instantiated head dims, ascending
#define FA_HEAD_DIMS(X) X(64) X(80) X(96) X(128)

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int Sq, int Sk, int D,
                    float scale, int causal, cudaStream_t s) {
  switch (D) {
#define FA_CASE(d)                                                       \
  case d:                                                                \
    return launch<T, d>(q, k, v, out, B, Hq, Hkv, Sq, Sk, scale, causal, \
                        s);
    FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_max_d(void) { return FA_MAX_D; }

// The head dim of the instance that runs head dim d: d itself, or the next
// instantiated one (the wrapper zero-pads to it); 0 above FA_MAX_D.
extern "C" int flash_attention_head_dim(int d) {
#define FA_PICK(n) \
  if (d <= n) return n;
  FA_HEAD_DIMS(FA_PICK)
#undef FA_PICK
  return 0;
}

// q, out: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); contiguous, 16-byte
// aligned; D an instantiated head dim, scale the true head dim's D^-0.5.
// Dtype codes: 0 f32, 1 bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B * Hq == 0 || Sq == 0) return 0;
  if (D < 1 || D > FA_MAX_D || flash_attention_head_dim(D) != D ||
      Hkv < 1 || Hq % Hkv || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                           s);
  return launch_d<bf16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                        s);
}
