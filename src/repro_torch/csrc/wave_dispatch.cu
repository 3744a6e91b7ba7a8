// Wave dispatch/dependency recurrence: one simulated core per lane.
//
// Replaces the TPU kernel `kernel` inside `_build_pallas_fn`
// (src/repro/core/batch_sim.py, the `pl.pallas_call` of the wave-execution
// backend).  Semantics are those of that kernel; everything is int32:
//
//   for j in 0..S-1, per lane e:
//     val_r  = (prod[j,r] < 0 ? 0 : done[prod[j,r]]) + delta[j,r]
//     ready  = max(issue[j], max_r val_r)
//     t_p    = max(ready, port_free[p])   for every port lut[mask_id[j]] allows
//     best   = lexicographic argmin of (t_p, count[p], p)
//     valid[j] ? (done[j] = tmin + lat[j], port_free[best] = tmin + blk[j],
//                 count[best] += 1)
//              : (done[j] = 0, nothing else changes)
//
// When no port is allowed (or every candidate time is INT32_MAX) all ports
// tie on the INT32_MAX sentinel and the least-count, lowest-index port wins,
// as in the TPU kernel.  Sums wrap in 32 bits as the TPU kernel's do.
//
// Layout: every per-row input and `done` are (S, E) row-major, prod/delta
// (S, E, R), so the 32 lanes of a warp touch one contiguous segment of row j
// at each step.  counts is (E, P).  The LUT (M, P) of bools is folded into M
// 32-bit port masks in shared memory once per block.
//
// Design: one thread per lane, 128 lanes per block; port_free and count live
// in registers (MAXP = 32, loops over ports fully unrolled so that no array
// spills to local memory); lanes are independent and the loop over rows is
// serial.
//
// What bounds it on an H100: not bytes.  Each lane is a serial chain of S
// dependent steps (a step's reads depend on `done` values written by earlier
// steps of the same lane, through global memory), and a chunk has at most a
// few hundred lanes, so at most ~3 blocks are busy on 132 SMs.  The time is
// S times the latency of one step.  Making it fast is later work: several
// lanes per warp sharing a μop row, a window of `done` in shared memory for
// short producer distances, and CUDA graphs over a campaign's chunks.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAXP 32
#define LANES_PER_BLOCK 128

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned int)a + (unsigned int)b);
}

__global__ void __launch_bounds__(LANES_PER_BLOCK)
wave_dispatch_kernel(const int* __restrict__ issue,
                     const int* __restrict__ mask_id,
                     const int* __restrict__ lat,
                     const int* __restrict__ blk,
                     const bool* __restrict__ valid,
                     const int* __restrict__ prod,
                     const int* __restrict__ delta,
                     const bool* __restrict__ lut,
                     int* done, int* __restrict__ counts,
                     int S, int E, int R, int M, int P) {
  extern __shared__ unsigned int allow[];  // M port bitmasks
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    unsigned int bits = 0u;
    for (int p = 0; p < P; ++p)
      if (lut[(size_t)m * P + p]) bits |= 1u << p;
    allow[m] = bits;
  }
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;

  int pf[MAXP];
  int cnt[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    pf[p] = 0;
    cnt[p] = 0;
  }

  for (int j = 0; j < S; ++j) {
    const size_t row = (size_t)j * E + e;
    if (!valid[row]) {  // padding or stale rows of a reused buffer
      done[row] = 0;
      continue;
    }
    int ready = issue[row];
    const int* pr = prod + row * R;
    const int* de = delta + row * R;
    for (int r = 0; r < R; ++r) {
      const int src = pr[r];
      // a valid row's producers are earlier rows of the same lane
      const int v = src < 0 ? 0 : done[(size_t)min(src, S - 1) * E + e];
      ready = max(ready, wrap_add(v, de[r]));
    }
    const int mid = mask_id[row];
    const unsigned int a = (mid >= 0 && mid < M) ? allow[mid] : 0u;
    int tmin = INT_MAX, cmin = INT_MAX, best = 0;
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      if (p < P && ((a >> p) & 1u)) {
        const int t = max(ready, pf[p]);
        if (t < tmin || (t == tmin && cnt[p] < cmin)) {
          tmin = t;
          cmin = cnt[p];
          best = p;
        }
      }
    }
    if (tmin == INT_MAX) {  // every port ties on the sentinel
      cmin = INT_MAX;
#pragma unroll
      for (int p = 0; p < MAXP; ++p) {
        if (p < P && cnt[p] < cmin) {
          cmin = cnt[p];
          best = p;
        }
      }
    }
    done[row] = wrap_add(tmin, lat[row]);
    const int free_at = wrap_add(tmin, blk[row]);
#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      if (p == best) {
        pf[p] = free_at;
        cnt[p] += 1;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < MAXP; ++p)  // constant indices keep cnt in registers
    if (p < P) counts[(size_t)e * P + p] = cnt[p];
}

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() of the launch; does not synchronize.
extern "C" int wave_dispatch_launch(const void* issue, const void* mask_id,
                                    const void* lat, const void* blk,
                                    const void* valid, const void* prod,
                                    const void* delta, const void* lut,
                                    void* done, void* counts, int S, int E,
                                    int R, int M, int P, void* stream) {
  if (E <= 0 || S <= 0) return 0;
  const int blocks = (E + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  const size_t smem = (size_t)M * sizeof(unsigned int);
  wave_dispatch_kernel<<<blocks, LANES_PER_BLOCK, smem,
                         (cudaStream_t)stream>>>(
      (const int*)issue, (const int*)mask_id, (const int*)lat,
      (const int*)blk, (const bool*)valid, (const int*)prod,
      (const int*)delta, (const bool*)lut, (int*)done, (int*)counts, S, E,
      R, M, P);
  return (int)cudaGetLastError();
}

extern "C" int wave_dispatch_max_ports(void) { return MAXP; }
