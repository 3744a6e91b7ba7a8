// RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w over the last axis, in f32.
//
// Replaces the TPU kernel `_rmsnorm_kernel` (the `pl.pallas_call` of
// `rmsnorm`) in src/repro/kernels/rmsnorm.py.  Same arithmetic, in the same
// order: the row's sum of squares in f32, var = sum / d, y = x * rsqrt(var +
// eps), then y * w, rounded to nearest into x's dtype.
//
// What bounds it on this card: HBM bytes.  Each element is read once and
// written once (~1 FLOP a byte), far below the card's ~20 FLOP a byte at
// the f32 rate, so the kernel is a streaming pass.  Design: one warp per
// row, 8 rows per CTA, so a row needs no block-wide barrier (the sum of
// squares is reduced with shuffles) and any row count runs without padding
// (the TPU kernel pads the rows to its 256-row block).  Where d is a
// multiple of the 16-byte pack (4 f32, 8 bf16; the wrapper checks that the
// tensors are 16-byte aligned) each lane loads and stores 16 bytes at a
// time; any other d takes one element a lane.  The second pass re-reads
// the row, which the first pass has just brought into L1.
//
// x and out are f32 or bf16 (one type, a template parameter); w is f32 or
// bf16, chosen at run time by which of the two pointers is set.
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RMS_WARPS 8
#define RMS_THREADS (32 * RMS_WARPS)

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

template <typename T>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel_vec(const T* __restrict__ x, const float* __restrict__ w_f32,
                   const __nv_bfloat16* __restrict__ w_bf16,
                   T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte pack
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = to_f32(e[i]);
      ss += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int c = lane * V; c < d; c += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float wv = w_f32 ? w_f32[c + i] : __bfloat162float(w_bf16[c + i]);
      o[i] = from_f32<T>(to_f32(e[i]) * r * wv);
    }
    *reinterpret_cast<uint4*>(orow + c) = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel_scalar(const T* __restrict__ x,
                      const float* __restrict__ w_f32,
                      const __nv_bfloat16* __restrict__ w_bf16,
                      T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int c = lane; c < d; c += 32) {
    const float wv = w_f32 ? w_f32[c] : __bfloat162float(w_bf16[c]);
    orow[c] = from_f32<T>(to_f32(xr[c]) * r * wv);
  }
}

template <typename T>
static int launch(const void* x, const void* w, int w_bf16, void* out,
                  long long rows, int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* wf = w_bf16 ? nullptr : (const float*)w;
  const __nv_bfloat16* wb = w_bf16 ? (const __nv_bfloat16*)w : nullptr;
  if (d % (16 / (int)sizeof(T)) == 0)
    rmsnorm_kernel_vec<T><<<(int)blocks, RMS_THREADS, 0, stream>>>(
        (const T*)x, wf, wb, (T*)out, rows, d, eps);
  else
    rmsnorm_kernel_scalar<T><<<(int)blocks, RMS_THREADS, 0, stream>>>(
        (const T*)x, wf, wb, (T*)out, rows, d, eps);
  return (int)cudaGetLastError();
}

// x, out: (rows, d) contiguous, 16-byte aligned; w: (d,).  Dtype codes:
// 0 f32, 1 bf16.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long rows, int d, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || (x_dtype != 0 && x_dtype != 1) ||
      (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0) return launch<float>(x, w, w_dtype, out, rows, d, eps, s);
  return launch<__nv_bfloat16>(x, w, w_dtype, out, rows, d, eps, s);
}
