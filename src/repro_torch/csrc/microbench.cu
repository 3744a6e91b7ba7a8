// Unit blockers: four kernels, each of which saturates one unit of the card.
//
// Replace the TPU kernels of src/repro/kernels/microbench.py, the TPU form of
// the paper's blocking instructions (section 5.1.1), one `pl.pallas_call`
// each:
//
//   mxu_chain_kernel  <- `_mxu_kernel` (mxu_blocker): `iters` chained
//                        acc = acc @ b, f32, on the tensor cores
//   vpu_chain_kernel  <- `_vpu_kernel` (vpu_blocker): acc = acc*1.000001+0.5,
//                        on the FP32 pipe (FFMA)
//   sfu_chain_kernel  <- `_sfu_kernel` (sfu_blocker): acc = rsqrt(acc+1.5),
//                        on the multi-function unit (MUFU.RSQ)
//   lsu_stream_kernel <- `_lsu_kernel` (lsu_blocker): out = x + 1, streamed
//                        through HBM with 16-byte loads and stores
//
// `iters` is a runtime argument everywhere, so no compiler can fold or
// shorten a chain; each C entry point launches on the stream it is given,
// does not synchronize, and returns cudaGetLastError().
//
// MXU.  What bounds it: the tensor cores of the SMs the chain runs on, at
// the rate mma.sync reaches for TF32 on this card.  Each product depends on
// the last, but row block w of acc @ b reads only row block w of acc, so
// the tile/16 blocks of 16 rows are independent chains.  Design: one CTA a
// row block (tile/16 CTAs: 8 of the 132 SMs at tile 128), one warp a
// column n-tile of 8 (16 warps, 4 on each of the SM's tensor-core
// sub-partitions), each computing its 16 x 8 piece of every product with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  Plain TF32 keeps 10
// mantissa bits, and 1.0001 (the reference's input) rounds to exactly 1.0
// there, so every operand is split x = big + small with big = tf32(x),
// small = tf32(x - big) and the product summed as small*big + big*small +
// big*big (3xTF32).  The split is done once an element: b's when it is
// loaded, the row block's when a product writes it, into shared memory
// (so the 16 warps that read one A fragment do not each split it again).
// The row block's parts sit in shared memory twice: a product reads one
// pair and writes the other, with one block barrier an iteration.  The
// tensor cores add into their f32 accumulator with truncation, which
// biases a long sum (measured on the H100: 2.2e-4 off after 64 products
// with an orthogonal b, against ~5e-6 for f32), so only the two small
// terms, ~2^-11 of the total, accumulate there over a whole product; each
// k-step's big*big term goes into a fresh accumulator and is added to the
// running sum by an FADD, which rounds to nearest: 4 FADD for every 3 mma.
// An output element's operations and their order do not depend on which
// CTA and warp compute it, so any split of the work gives the same bits.
// Shared memory at tile 128: five 16 x 132 planes of the row block (two
// big, two small, one f32) and b's two 128 x 136 parts, 181,504 bytes
// (rows padded so that fragment loads hit distinct banks).  tile must be a
// multiple of 16 and at most MXU_MAX_TILE.  Not tried: a cluster of CTAs a
// row block splitting its columns over more SMs.
//
// VPU.  What bounds it: FP32 issue.  One thread per element, a dependent
// fmaf chain each; a grid over every element, so rows >= 2,112 fill all
// 132 SMs at 2,048 resident threads each.  fmaf contracts the multiply and
// the add into one FFMA (one rounding, where the plain version rounds twice).
//
// SFU.  What bounds it: the MUFU rate (16 per SM per clock on sm_90).
// rsqrtf compiles to MUFU.RSQ; 1.0f/sqrtf would compile to an IEEE square
// root and a division instead.  The chain converges to a fixed point, so
// rounding does not accumulate.
//
// LSU.  What bounds it: HBM bandwidth, 8 bytes moved per element.
// Grid-stride float4 loads and stores, at most 8 blocks of 256 threads per
// SM.  Every row is written (the TPU kernel's grid leaves the tail rows
// past a multiple of 512 unwritten).

#include <cuda_runtime.h>
#include <stdint.h>

#define MXU_MAX_TILE 128
#define MXU_ROWS 16    // rows of acc a CTA owns
#define MXU_WARPS (MXU_MAX_TILE / 8)  // warps a CTA: one 8-column n-tile each
#define MXU_THREADS (32 * MXU_WARPS)
#define MXU_PLANES 5   // row-block planes in shared memory
#define MXU_PAD_A 4  // lda = tile + 4: A-fragment loads hit 32 banks
#define MXU_PAD_B 8  // ldb = tile + 8: B-fragment loads hit 32 banks
#define ELEM_THREADS 256

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// c += a * b on the tensor cores, m16n8k8, tf32 operands, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static size_t mxu_smem_bytes(int tile) {
  return sizeof(float) * (MXU_PLANES * (size_t)MXU_ROWS * (tile + MXU_PAD_A) +
                          2 * (size_t)tile * (tile + MXU_PAD_B));
}

// x = big + small, both tf32 values (as f32 bits): the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, float* big, float* small) {
  const uint32_t hi = to_tf32(x);
  *big = __uint_as_float(hi);
  *small = __uint_as_float(to_tf32(x - __uint_as_float(hi)));
}

__global__ void __launch_bounds__(MXU_THREADS)
mxu_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int tile, int iters) {
  extern __shared__ float smem[];
  const int lda = tile + MXU_PAD_A, ldb = tile + MXU_PAD_B;
  const int plane = MXU_ROWS * lda;
  // planes 0, 1: the row block's tf32 big parts (read one, write the
  // other); 2, 3: its small parts; 4: its f32 values (at the start and
  // after the last product)
  float* const acc = smem + 4 * plane;
  float* const b_big = smem + MXU_PLANES * plane;  // tile x ldb
  float* const b_small = b_big + tile * ldb;       // tile x ldb
  const int r0 = blockIdx.x * MXU_ROWS;  // this CTA's row block
  for (int i = threadIdx.x; i < MXU_ROWS * tile; i += blockDim.x) {
    const int r = i / tile, c = i - r * tile;
    const float x = a[(size_t)(r0 + r) * tile + c];
    acc[r * lda + c] = x;
    split_tf32(x, smem + r * lda + c, smem + 2 * plane + r * lda + c);
  }
  for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
    const int r = i / tile, c = i - r * tile;
    split_tf32(b[i], b_big + r * ldb + c, b_small + r * ldb + c);
  }
  __syncthreads();

  // fragment coordinates (PTX ISA, mma.m16n8k8 .tf32): A a0..a3 at
  // (g, t), (g+8, t), (g, t+4), (g+8, t+4); B b0, b1 at (k=t, n=g),
  // (k=t+4, n=g); C c0..c3 at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  // Warp w computes n-tile w: columns 8w..8w+7 of the row block.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool mine = warp < tile / 8;
  const float* bb = b_big + t * ldb + warp * 8 + g;
  const float* bs = b_small + t * ldb + warp * 8 + g;
  const int frag = g * lda + t;  // a0's offset in a plane
  const int col = g * lda + warp * 8 + 2 * t;  // c0's offset in a plane
  for (int it = 0; it < iters; ++it) {
    const int cur = (it & 1) * plane, nxt = plane - cur;
    float c_big[4] = {0.f, 0.f, 0.f, 0.f}, c_small[4] = {0.f, 0.f, 0.f, 0.f};
    if (mine) {
      const float* ah = smem + cur + frag;
      const float* al = smem + 2 * plane + cur + frag;
#pragma unroll 4
      for (int k0 = 0; k0 < tile; k0 += 8) {
        uint32_t ab[4], as[4];
        ab[0] = __float_as_uint(ah[k0]);
        ab[1] = __float_as_uint(ah[8 * lda + k0]);
        ab[2] = __float_as_uint(ah[k0 + 4]);
        ab[3] = __float_as_uint(ah[8 * lda + k0 + 4]);
        as[0] = __float_as_uint(al[k0]);
        as[1] = __float_as_uint(al[8 * lda + k0]);
        as[2] = __float_as_uint(al[k0 + 4]);
        as[3] = __float_as_uint(al[8 * lda + k0 + 4]);
        const uint32_t hb0 = __float_as_uint(bb[k0 * ldb]);
        const uint32_t hb1 = __float_as_uint(bb[(k0 + 4) * ldb]);
        const uint32_t lb0 = __float_as_uint(bs[k0 * ldb]);
        const uint32_t lb1 = __float_as_uint(bs[(k0 + 4) * ldb]);
        mma_tf32(c_small, as, hb0, hb1);
        mma_tf32(c_small, ab, lb0, lb1);
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(step, ab, hb0, hb1);
#pragma unroll
        for (int q = 0; q < 4; ++q) c_big[q] += step[q];
      }
      // the new row block: its f32 values after the last product, else
      // its tf32 parts in the other planes
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = col + (q >> 1) * 8 * lda + (q & 1);
        const float x = c_big[q] + c_small[q];
        if (it + 1 == iters)
          acc[at] = x;
        else
          split_tf32(x, smem + nxt + at, smem + 2 * plane + nxt + at);
      }
    }
    __syncthreads();  // the new row block is whole; the old one is free
  }
  for (int i = threadIdx.x; i < MXU_ROWS * tile; i += blockDim.x) {
    const int r = i / tile, c = i - r * tile;
    out[(size_t)(r0 + r) * tile + c] = acc[r * lda + c];
  }
}

__global__ void __launch_bounds__(ELEM_THREADS)
vpu_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int k = 0; k < iters; ++k) acc = fmaf(acc, 1.000001f, 0.5f);
  out[i] = acc;
}

__global__ void __launch_bounds__(ELEM_THREADS)
sfu_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = x[i];
  for (int k = 0; k < iters; ++k) acc = rsqrtf(acc + 1.5f);
  out[i] = acc;
}

__global__ void __launch_bounds__(ELEM_THREADS)
lsu_stream_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                  long long n4) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    float4 v = x[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    out[i] = v;
  }
}

static int elem_blocks(long long n) {
  return (int)((n + ELEM_THREADS - 1) / ELEM_THREADS);
}

extern "C" int microbench_mxu_max_tile(void) { return MXU_MAX_TILE; }

// CTAs a launch at `tile` runs: one a row block (0 for a tile the kernel
// does not take).
extern "C" int mxu_chain_ctas(int tile) {
  if (tile < MXU_ROWS || tile > MXU_MAX_TILE || tile % MXU_ROWS) return 0;
  return tile / MXU_ROWS;
}

extern "C" int mxu_chain_launch(const void* a, const void* b, void* out,
                                int tile, int iters, void* stream) {
  const int ctas = mxu_chain_ctas(tile);
  if (ctas == 0) return cudaErrorInvalidValue;
  const size_t smem = mxu_smem_bytes(tile);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mxu_chain_kernel<<<ctas, MXU_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, tile, iters);
  return (int)cudaGetLastError();
}

extern "C" int vpu_chain_launch(const void* x, void* out, long long n,
                                int iters, void* stream) {
  if (n <= 0) return 0;
  vpu_chain_kernel<<<elem_blocks(n), ELEM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int sfu_chain_launch(const void* x, void* out, long long n,
                                int iters, void* stream) {
  if (n <= 0) return 0;
  sfu_chain_kernel<<<elem_blocks(n), ELEM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, iters);
  return (int)cudaGetLastError();
}

// n: floats, a multiple of 4; x and out 16-byte aligned.
extern "C" int lsu_stream_launch(const void* x, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n % 4) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n4 = n / 4;
  long long blocks = (n4 + ELEM_THREADS - 1) / ELEM_THREADS;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  lsu_stream_kernel<<<(int)blocks, ELEM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}
