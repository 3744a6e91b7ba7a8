// RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w over the last axis, in f32.
//
// Replaces the TPU kernel `_rmsnorm_kernel` (the `pl.pallas_call` of
// `rmsnorm`) in src/repro/kernels/rmsnorm.py.  Same arithmetic, in the same
// order: the row's sum of squares in f32, var = sum / d, y = x * rsqrt(var +
// eps), then y * w, rounded to nearest into x's dtype.
//
// What bounds it on this card: HBM bytes.  Each element is read once and
// written once (~1 FLOP a byte), far below the card's ~20 FLOP a byte at
// the f32 rate, so the kernel is a streaming pass whose only aim is to keep
// enough bytes in flight.  Design: one warp per row, so a row needs no
// block-wide barrier (the sum of squares is reduced with shuffles) and any
// row count runs without padding (the TPU kernel pads the rows to its
// 256-row block).
// * rmsnorm_kernel_regs (d a multiple of the 16-byte pack, 4 f32 or 8 bf16,
//   and at most RMS_MAX_PACKS packs a lane): the row lives in registers.
//   The kernel is templated on the packs a lane holds (NP), so the loops
//   unroll and a lane issues all NP 16-byte loads of a row before it uses
//   one (8 in flight at d = 960 f32, 10 at d = 2560 bf16), and issues the
//   next row's while it reduces and writes this one; x is read from HBM
//   once, with a streaming hint, and out written as 16-byte packs.
//   w is loaded once per warp as packs, converted to f32 in registers and
//   reused for every row the warp takes: the grid is sized to what the
//   card holds at once, and each warp loops over rows.  NP is instantiated
//   at the pack counts of the configs' d_model widths (RMS_PACK_COUNTS); a
//   row that needs fewer runs the next count up, its extra packs idle.
// * rmsnorm_kernel_vec (d a multiple of the pack, wider rows): two passes
//   over the row with 16-byte loads; the second re-reads the row, which
//   the first has just brought into L1.
// * rmsnorm_kernel_scalar (any other d): one element a lane.
// The wrapper hands over contiguous, 16-byte aligned tensors.
//
// x and out are f32 or bf16 (one type, a template parameter); w is f32 or
// bf16, chosen at run time by which of the two pointers is set.
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RMS_WARPS 2  // small blocks: the card-sized grid splits evenly
#define RMS_THREADS (32 * RMS_WARPS)
#define RMS_MAX_PACKS 12  // 16-byte packs of its row a lane holds
// the instantiated NP, ascending: bf16 d = 960/1024 (4), 1536 (6), 2560
// (10), 3072 (12); f32 d = 960/1024 (8), 1536 (12)
#define RMS_PACK_COUNTS(X) X(4) X(6) X(8) X(10) X(12)

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

// w[c .. c + V) as f32 (V a multiple of 4; c a multiple of V)
template <int V>
__device__ __forceinline__ void load_w(const float* __restrict__ w_f32,
                                       const __nv_bfloat16* __restrict__ w_bf16,
                                       int c, float wv[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    if (w_f32) {
      const float4 f = *reinterpret_cast<const float4*>(w_f32 + c + i);
      wv[i] = f.x;
      wv[i + 1] = f.y;
      wv[i + 2] = f.z;
      wv[i + 3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(w_bf16 + c + i);
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[i + j] = __bfloat162float(b[j]);
    }
  }
}

// A lane's packs of one row (zeros past d), with a streaming hint
template <typename T, int NP>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, int d,
                                         int lane, uint4 raw[NP]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = (lane + 32 * i) * V;
    raw[i] = c < d ? __ldcs(reinterpret_cast<const uint4*>(xr + c))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Lane l holds packs l, l + 32, ..., l + 32 (NP - 1) of its row (those
// below d / V): each step of the warp reads 512 contiguous bytes.
template <typename T, int NP>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_kernel_regs(const T* __restrict__ x, const float* __restrict__ w_f32,
                    const __nv_bfloat16* __restrict__ w_bf16,
                    T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte pack
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * RMS_WARPS;
  long long row = (long long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  uint4 raw[NP];  // the next row's packs, loaded a row ahead
  if (row < rows) load_row<T, NP>(x + row * d, d, lane, raw);
  float wv[NP][V];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = (lane + 32 * i) * V;
    if (c < d) load_w<V>(w_f32, w_bf16, c, wv[i]);
  }
  for (; row < rows; row += stride) {  // the whole warp takes one row
    uint4 cur[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) cur[i] = raw[i];
    if (row + stride < rows)
      load_row<T, NP>(x + (row + stride) * d, d, lane, raw);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f32(e[j]);
        ss += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / (float)d + eps);
    T* orow = out + row * d;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = (lane + 32 * i) * V;
      if (c < d) {
        const T* e = reinterpret_cast<const T*>(&cur[i]);
        uint4 res;
        T* o = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = from_f32<T>(to_f32(e[j]) * r * wv[i][j]);
        __stcs(reinterpret_cast<uint4*>(orow + c), res);
      }
    }
  }
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

// blocks of rmsnorm_kernel_regs<T, NP> one SM holds at once
template <typename T, int NP>
static int resident_blocks() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rmsnorm_kernel_regs<T, NP>, RMS_THREADS, 0) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

template <typename T, int NP>
static int launch_regs(const T* x, const float* wf, const __nv_bfloat16* wb,
                       T* out, long long rows, int d, float eps,
                       cudaStream_t stream) {
  static const int per_sm = resident_blocks<T, NP>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // as many rows for every warp (rows / warps rounded up), and the fewest
  // blocks that take them all: no warp's loop runs a row longer than needed
  const long long fill = (long long)sms * per_sm * RMS_WARPS;
  const long long per_warp = (rows + fill - 1) / fill;
  const long long warps = (rows + per_warp - 1) / per_warp;
  const int blocks = (int)((warps + RMS_WARPS - 1) / RMS_WARPS);
  rmsnorm_kernel_regs<T, NP><<<blocks, RMS_THREADS, 0, stream>>>(
      x, wf, wb, out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* w, int w_bf16, void* out,
                  long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const long long blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = (const T*)x;
  T* ot = (T*)out;
  const float* wf = w_bf16 ? nullptr : (const float*)w;
  const __nv_bfloat16* wb = w_bf16 ? (const __nv_bfloat16*)w : nullptr;
  if (d % V == 0) {
    const int need = (d / V + 31) / 32;  // packs a lane holds
#define RMS_PICK(np) \
  if (need <= np)    \
    return launch_regs<T, np>(xt, wf, wb, ot, rows, d, eps, stream);
    RMS_PACK_COUNTS(RMS_PICK)
#undef RMS_PICK
    static_assert(RMS_MAX_PACKS == 12, "the largest pack count");
    rmsnorm_kernel_vec<T><<<(int)blocks, RMS_THREADS, 0, stream>>>(
        xt, wf, wb, ot, rows, d, eps);
  } else {
    rmsnorm_kernel_scalar<T><<<(int)blocks, RMS_THREADS, 0, stream>>>(
        xt, wf, wb, ot, rows, d, eps);
  }
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
