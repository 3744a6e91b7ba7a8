// Flash attention forward: online-softmax attention, causal or
// bidirectional, with grouped-query heads.
//
// Replaces the TPU kernel `_flash_kernel` (the `pl.pallas_call` of
// `flash_attention_fwd`) in src/repro/kernels/flash_attention.py, with its
// semantics kept exactly: scores s = (q . k) * D^-0.5 in f32; causal
// positions aligned top-left from 0 (query i sees keys j <= i, also when
// Sq != Sk) and masked with NEG_INF = -1e30, never -inf (exp(-inf - -inf) is
// NaN); per query row a running max m, sum l and accumulator acc[D], updated
// per key tile as m' = max(m, max s), alpha = exp(m - m'), p = exp(s - m'),
// l' = l * alpha + sum p, acc' = acc * alpha + p v; out = acc / (l == 0 ? 1 :
// l), rounded to nearest into the inputs' dtype.  A key tile is skipped only
// where it lies wholly above the diagonal.  Flat head bh = b * Hq + h reads
// KV head b * Hkv + h / (Hq / Hkv).
//
// What bounds it on this card: operations (4 * D FLOP per computed
// query/key pair; at SmolLM-360M's geometry, 4096 tokens, ~1,500 FLOP a
// byte of bf16 q, k, v and out, far above the card's balance point).  This
// first kernel uses no tensor cores and no TMA: every product is an f32 FMA
// on the CUDA cores, which also keeps the f32 result within the reference's
// 2e-5.  Design: one CTA
// of 256 threads per (flat head, 64-query tile), heavy causal tiles first;
// the query tile and each 64-key tile of K and V are staged as f32 in
// dynamic shared memory (rows padded to D + 1 floats so that lanes reading
// different rows hit different banks).  Thread (ty, tx) of a 16 x 16 grid
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 j (j < DMAX / 16), with m, l and its part of acc in
// registers; a row's max and sum are reduced over its 16 threads with
// shuffles, and the probabilities go through shared memory to the P V
// product.  D <= 128; the query and K/V tiles (and P) take 120 KB at D =
// 128, above the 48 KB default, so the launch raises the limit.
//
// q, k, v and out are all f32 or all bf16.  The C entry point launches on
// the stream it is given, does not synchronize, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_MAX_D 128
#define FA_LDP (FA_BK + 16)  // P rows: rows ty and ty + 1 16 banks apart
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

static size_t fa_smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)(FA_BQ + 2 * FA_BK) * (d + 1) + (size_t)FA_BQ * FA_LDP);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int Sq, int Sk, int D, float scale, int causal) {
  constexpr int DJ = DMAX / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;               // FA_BQ x ld
  float* ks = qs + FA_BQ * ld;    // FA_BK x ld
  float* vs = ks + FA_BK * ld;    // FA_BK x ld
  float* ps = vs + FA_BK * ld;    // FA_BQ x FA_LDP

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;  // heavy tiles first
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + (size_t)kvh * Sk * D;
  const T* vp = v + (size_t)kvh * Sk * D;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int r = e / D, c = e - r * D;
    qs[r * ld + c] = q0 + r < Sq ? to_f32(qp[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: tiles from k0 = q0 + FA_BQ on lie wholly above the diagonal
  const int kend = causal ? min(Sk, q0 + FA_BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int r = e / D, c = e - r * D;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * D + c;
      ks[r * ld + c] = in ? to_f32(kp[g]) : 0.f;
      vs[r * ld + c] = in ? to_f32(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (causal && row < col) val = FA_NEG_INF;
        s[i][j] = val;
        if (col < Sk) mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int o = 8; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < Sk ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * FA_LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(FA_BK, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * FA_LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float vv = vs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* op = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) op[(size_t)row * D + c] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                  int causal, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * Hq);
  flash_fwd_kernel<T, DMAX><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, D,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    int B, int Hq, int Hkv, int Sq, int Sk, int D,
                    float scale, int causal, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                         s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                         s);
  return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                        s);
}

extern "C" int flash_attention_max_d(void) { return FA_MAX_D; }

// q, out: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); contiguous.  Dtype codes:
// 0 f32, 1 bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B * Hq == 0 || Sq == 0) return 0;
  if (D < 1 || D > FA_MAX_D || Hkv < 1 || Hq % Hkv || B * Hq > 65535 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                           s);
  return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale,
                                 causal, s);
}
