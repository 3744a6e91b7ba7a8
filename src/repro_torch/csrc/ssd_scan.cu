// Mamba2 SSD (state-space duality) chunk scan.
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
// What bounds it on this card: operations (at Mamba2-2.7B's width, Q =
// 256, P = 64, N = 128, ~150 FLOP a byte of f32 x, B, C and y), and before
// them the chunk recurrence: the TPU kernel runs its chunk axis in order on
// one core, and here one CTA per (batch, head) walks its chunks in order, so
// the grid has only b * h CTAs (160 at Mamba2-2.7B width on 132 SMs).  This
// first kernel uses no tensor cores and no TMA: every product is an f32
// FMA.
// Design: the state lives in shared memory for the whole scan (P x (N + 1)
// f32, 32 KB at P = 64, N = 128).  One chunk's Q x Q block (256 KB at Q =
// 256) does not fit a CTA's 227 KB, so the chunk is tiled by 32 rows: for
// each 32-row tile of C, y_off from the state, then for every 32-row tile of
// B and xbar at or below it, the 32 x 32 masked scores and their product
// with xbar; then the state update from 32-row tiles of B and xbar.  cumsum
// runs as a warp scan over the chunk.  Thread (ty, tx) of a 16 x 16 grid
// owns score (ty + 16 a, tx + 16 b), y (ty + 16 a, tx + 16 c) and state
// (ty + 16 a, tx + 16 b) entries in registers; shared rows are padded to
// N + 1 (and 33) floats so that lanes reading different rows hit different
// banks.  P <= 64, N <= 128; ~80 KB of shared memory at Q = 256, so two
// CTAs fit an SM.
//
// x and y are f32 or bf16, B and C (one type) f32 or bf16, dt and A f32.
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSD_THREADS 256
#define SSD_T 32  // rows of a chunk in one tile
#define SSD_MAX_P 64
#define SSD_MAX_N 128
#define SSD_MAX_SMEM (227 * 1024)

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

static size_t ssd_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * ((size_t)(P + 2 * SSD_T) * (N + 1) +
                          (size_t)SSD_T * P + SSD_T * (SSD_T + 1) + Q);
}

template <typename T, typename U>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const U* __restrict__ Bm,
                const U* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int G,
                int N, int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1, lds = SSD_T + 1;
  float* st = smem;               // P x ldn: the state
  float* cs = st + P * ldn;       // SSD_T x ldn: C rows of tile i
  float* bs = cs + SSD_T * ldn;   // SSD_T x ldn: B rows of tile j
  float* xs = bs + SSD_T * ldn;   // SSD_T x P: xbar rows of tile j
  float* ss = xs + SSD_T * P;     // SSD_T x lds: masked scores
  float* cum = ss + SSD_T * lds;  // Q

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  // row t of x/y, dt and B/C for this (b, h)
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P;
  T* yb = y + (size_t)b * S * xrow + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;
  const U* Bb = Bm + (size_t)b * S * brow + (size_t)g * N;
  const U* Cb = Cm + (size_t)b * S * brow + (size_t)g * N;

  for (int e = tid; e < P * ldn; e += SSD_THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the last chunk's state update is done
    for (int i = tid; i < Q; i += SSD_THREADS)
      cum[i] = dtb[(size_t)(c0 + i) * H] * a;
    __syncthreads();
    if (tid < 32) {  // inclusive scan, 32 steps at a time
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? cum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cl = cum[Q - 1];

    // ---- y, one 32-row tile of the chunk at a time
    for (int i0 = 0; i0 < Q; i0 += SSD_T) {
      for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
        const int r = e / N, n = e - r * N;
        cs[r * ldn + n] =
            i0 + r < Q ? to_f32(Cb[(size_t)(c0 + i0 + r) * brow + n]) : 0.f;
      }
      __syncthreads();
      float yo[2][4], yd[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yo[r][c] = yd[r][c] = 0.f;
      // y_off = (C state^T) * exp(cum), with the state entering the chunk
      for (int n = 0; n < N; ++n) {
        float cv[2], sv[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) cv[r] = cs[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? st[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yo[r][c] = fmaf(cv[r], sv[c], yo[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + ty + 16 * r;
        const float dec = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) yo[r][c] *= dec;
      }
      // y_diag over the tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += SSD_T) {
        __syncthreads();  // the last tile's B, xbar and scores are read
        for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
          const int r = e / N, n = e - r * N;
          bs[r * ldn + n] =
              j0 + r < Q ? to_f32(Bb[(size_t)(c0 + j0 + r) * brow + n]) : 0.f;
        }
        for (int e = tid; e < SSD_T * P; e += SSD_THREADS) {
          const int r = e / P, p = e - r * P;
          const size_t t = (size_t)(c0 + j0 + r);
          xs[e] = j0 + r < Q ? to_f32(xb[t * xrow + p]) * dtb[t * H] : 0.f;
        }
        __syncthreads();
        float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int n = 0; n < N; ++n) {
          float cv[2], bv[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            cv[r] = cs[(ty + 16 * r) * ldn + n];
            bv[r] = bs[(tx + 16 * r) * ldn + n];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
            // exp only where i >= j: above the diagonal it may overflow
            const float L = (i >= j && i < Q) ? expf(cum[i] - cum[j]) : 0.f;
            ss[(ty + 16 * r) * lds + tx + 16 * c] = sc[r][c] * L;
          }
        __syncthreads();
        for (int jj = 0; jj < SSD_T; ++jj) {
          float sv[2], xv[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) sv[r] = ss[(ty + 16 * r) * lds + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < P ? xs[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) yd[r][c] = fmaf(sv[r], xv[c], yd[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P)
            yb[(size_t)(c0 + i) * xrow + p] = from_f32<T>(yd[r][c] + yo[r][c]);
        }
      }
      __syncthreads();  // cs is reloaded for the next tile
    }

    // ---- state = exp(cum[-1]) * state + xbar^T (B * exp(cum[-1] - cum))
    float up[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) up[r][c] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += SSD_T) {
      __syncthreads();
      for (int e = tid; e < SSD_T * N; e += SSD_THREADS) {
        const int r = e / N, n = e - r * N;
        const int j = j0 + r;
        bs[r * ldn + n] =
            j < Q ? to_f32(Bb[(size_t)(c0 + j) * brow + n]) * expf(cl - cum[j])
                  : 0.f;
      }
      for (int e = tid; e < SSD_T * P; e += SSD_THREADS) {
        const int r = e / P, p = e - r * P;
        const size_t t = (size_t)(c0 + j0 + r);
        xs[e] = j0 + r < Q ? to_f32(xb[t * xrow + p]) * dtb[t * H] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < SSD_T; ++jj) {
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ty + 16 * r;
          xv[r] = p < P ? xs[jj * P + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = tx + 16 * c;
          bv[c] = n < N ? bs[jj * ldn + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) up[r][c] = fmaf(xv[r], bv[c], up[r][c]);
      }
    }
    const float dc = expf(cl);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx + 16 * c;
        if (n < N) st[p * ldn + n] = st[p * ldn + n] * dc + up[r][c];
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += SSD_THREADS) {
    const int p = e / N, n = e - p * N;
    so[e] = st[p * ldn + n];
  }
}

template <typename T, typename U>
static int launch(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, void* y, void* state, int b, int S, int H,
                  int P, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, U><<<dim3(H, b), SSD_THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const U*)B,
      (const U*)C, (T*)y, (float*)state, S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scan_max_p(void) { return SSD_MAX_P; }
extern "C" int ssd_scan_max_n(void) { return SSD_MAX_N; }
// 1 where a (P, N) state and a chunk of Q steps fit a CTA's shared memory
extern "C" int ssd_scan_fits(int P, int N, int Q) {
  return ssd_smem_bytes(P, N, Q) <= SSD_MAX_SMEM;
}

// x, y: (b, S, H, P); dt: (b, S, H) f32; A: (H,) f32; B, C: (b, S, G, N);
// state: (b, H, P, N) f32; all contiguous.  Q divides S.  Dtype codes: 0
// f32, 1 bf16.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int b, int S, int H, int P, int G,
                               int N, int Q, int x_dtype, int bc_dtype,
                               void* stream) {
  if (b == 0 || H == 0) return 0;
  if (P < 1 || P > SSD_MAX_P || N < 1 || N > SSD_MAX_N || G < 1 || H % G ||
      Q < 1 || S % Q || b > 65535 || !ssd_scan_fits(P, N, Q) ||
      (x_dtype != 0 && x_dtype != 1) || (bc_dtype != 0 && bc_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && bc_dtype == 0)
    return launch<float, float>(x, dt, A, B, C, y, state, b, S, H, P, G, N, Q,
                                s);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, dt, A, B, C, y, state, b, S, H, P,
                                        G, N, Q, s);
  if (bc_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, A, B, C, y, state, b, S, H, P,
                                        G, N, Q, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, y, state, b, S,
                                              H, P, G, N, Q, s);
}
