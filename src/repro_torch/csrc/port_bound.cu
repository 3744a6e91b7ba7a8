// The min-cut port bound of a wave of blocks, exact in integers.
//
// Replaces the device kernel `port_bound_kernel` of
// `BatchPredictor._compile_kernel` in src/repro/service/batch_predictor.py
// (plain jax, not a Pallas kernel).  Same function: per row of u (B x C
// int32, one block's summed uop count for each port combination),
// demand[s] = sum_c u[c] * mask[c, s] over the model's min-cut candidate
// sets (mask C x S, 0/1; size S, each candidate's port count, >= 1), and
// the pair (num, den) = (demand[s*], size[s*]) whose ratio is the largest,
// found by the exact compare an * bd < bn * ad from (0, 1).  The host
// divides num / den in float64.  Two equal ratios may give two different
// pairs (the jax reduce may also pick either); their quotients are the same
// double, so only quotients are compared with the plain version.
//
// The caller keeps every row total times the largest size below 2^31 (the
// reference's guard, which routes other waves to the host), so demand fits
// int32; the cross products are taken in int64 all the same.
//
// What bounds it on this card: bytes, 4 * (B*C + C*S + S + 2*B), against a
// fixed cost of ~2 us a launch.  At the served models' C = 9..11 and
// S = 31..71 a wave of 10,000 rows is ~0.5 MB, ~0.15 us at the HBM rate:
// the launch's fixed cost outweighs the work, so a simple design is enough.
// Design: one warp a row.  Lane l takes the candidates s = l, l + 32, ...;
// the row's C counts are loaded once per 32 candidates by the lanes
// together (one coalesced load) and handed out with shuffles, so the mask is
// read along s, conflict-free.  Each lane keeps its best pair; five
// butterfly shuffles with the same exact compare give every lane the row's
// best.  mask and size sit in shared memory when (C*S + S) * 4 bytes fit in
// the 48 KB a block may take without opting in, else they are read through
// L1/L2.  The kernel launches at exactly B rows (no padding to a shape
// bucket: there is no compile per shape to avoid), and a row with no uops
// gives (0, 1).
//
// The C entry point launches on the stream it is given, does not
// synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define PB_WARPS 8  // rows a block
#define PB_THREADS (32 * PB_WARPS)
#define PB_SMEM_MAX (48 * 1024)
#define FULL_MASK 0xffffffffu

// an / ad < bn / bd, exactly (ad, bd > 0)
__device__ __forceinline__ bool ratio_less(int an, int ad, int bn, int bd) {
  return (long long)an * bd < (long long)bn * ad;
}

template <bool kSmem>
__global__ void __launch_bounds__(PB_THREADS)
    port_bound_kernel(const int* __restrict__ u,
                      const int* __restrict__ mask_g,
                      const int* __restrict__ size_g, int* __restrict__ num,
                      int* __restrict__ den, long long rows, int C, int S) {
  extern __shared__ int smem[];
  const int* mask = mask_g;
  const int* size = size_g;
  if (kSmem) {
    const int n = C * S;
    for (int i = threadIdx.x; i < n; i += PB_THREADS) smem[i] = mask_g[i];
    for (int i = threadIdx.x; i < S; i += PB_THREADS) smem[n + i] = size_g[i];
    __syncthreads();
    mask = smem;
    size = smem + n;
  }
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * PB_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves: its shuffles stay full
  const int* urow = u + row * C;
  int an = 0, ad = 1;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool live = s < S;
    int d = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int v = (c0 + lane < C) ? urow[c0 + lane] : 0;
      const int n = min(32, C - c0);
      for (int j = 0; j < n; ++j) {
        const int uc = __shfl_sync(FULL_MASK, v, j);
        if (live) d += uc * mask[(c0 + j) * S + s];
      }
    }
    if (live) {
      const int bd = size[s];
      if (ratio_less(an, ad, d, bd)) {
        an = d;
        ad = bd;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int bn = __shfl_xor_sync(FULL_MASK, an, off);
    const int bd = __shfl_xor_sync(FULL_MASK, ad, off);
    if (ratio_less(an, ad, bn, bd)) {
      an = bn;
      ad = bd;
    }
  }
  if (lane == 0) {
    num[row] = an;
    den[row] = ad;
  }
}

extern "C" int port_bound_launch(const void* u, const void* mask,
                                 const void* size, void* num, void* den,
                                 long long rows, int C, int S, void* stream) {
  if (rows <= 0) return 0;
  if (C < 0 || S < 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + PB_WARPS - 1) / PB_WARPS);
  const size_t smem = ((size_t)C * S + S) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  const int* ui = (const int*)u;
  const int* mi = (const int*)mask;
  const int* si = (const int*)size;
  if (smem <= PB_SMEM_MAX)
    port_bound_kernel<true><<<blocks, PB_THREADS, smem, s>>>(
        ui, mi, si, (int*)num, (int*)den, rows, C, S);
  else
    port_bound_kernel<false><<<blocks, PB_THREADS, 0, s>>>(
        ui, mi, si, (int*)num, (int*)den, rows, C, S);
  return (int)cudaGetLastError();
}
