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
// MXU.  What bounds it: the chain.  Each product depends on the last, so
// the chain runs in one CTA on one SM of 132 (the bound over the whole card
// is 2*tile^3*iters FLOP at the TF32 peak).  Design: acc and b live in
// dynamic shared memory for the whole chain (128x128 f32 each, rows padded
// so that fragment loads hit distinct banks; 202 KB at tile 128, above the
// 48 KB default and within the 227 KB a block may use).  Warp w owns rows
// 16w..16w+15 of acc and computes them with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  Row block w of acc @ b reads
// only row block w of acc, so a warp writes its rows back in place with no
// block-wide barrier between steps.  Plain TF32 keeps 10 mantissa bits, and
// 1.0001 (the reference's input) rounds to exactly 1.0 there, so every
// operand is split x = big + small with big = tf32(x), small =
// tf32(x - big) and the product summed as small*big + big*small + big*big
// (3xTF32).  b is split once into shared memory; acc's fragments are split
// as they are loaded.  The tensor cores add into their f32 accumulator
// with truncation, which biases a long sum (measured on the H100: 2.2e-4
// off after 64 products with an orthogonal b, against ~5e-6 for f32), so
// only the two small terms, ~2^-11 of the total, accumulate there over a
// whole product; each k-step's big*big term goes into a fresh accumulator
// and is added to the running sum by an FADD, which rounds to nearest:
// 4 FADD for every 3 mma.  tile must be a multiple of 16 (one warp per 16
// rows, 8-column n-tiles, 8-deep k-steps) and at most MXU_MAX_TILE (two
// sums of 16 n-tiles are 128 registers a thread; three padded 128x128
// operands fill 202 KB of shared memory).
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
#define MXU_NT_MAX (MXU_MAX_TILE / 8)  // n-tiles a warp holds
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
  return sizeof(float) * ((size_t)tile * (tile + MXU_PAD_A) +
                          2 * (size_t)tile * (tile + MXU_PAD_B));
}

__global__ void __launch_bounds__(2 * MXU_MAX_TILE)
mxu_chain_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int tile, int iters) {
  extern __shared__ float smem[];
  const int lda = tile + MXU_PAD_A, ldb = tile + MXU_PAD_B;
  float* acc = smem;                   // tile x lda
  float* b_big = acc + tile * lda;     // tile x ldb, tf32 values as f32
  float* b_small = b_big + tile * ldb;  // tile x ldb
  for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
    const int r = i / tile, c = i - r * tile;
    acc[r * lda + c] = a[i];
    const float x = b[i];
    const float big = __uint_as_float(to_tf32(x));
    b_big[r * ldb + c] = big;
    b_small[r * ldb + c] = __uint_as_float(to_tf32(x - big));
  }
  __syncthreads();

  // fragment coordinates (PTX ISA, mma.m16n8k8 .tf32): A a0..a3 at
  // (g, t), (g+8, t), (g, t+4), (g+8, t+4); B b0, b1 at (k=t, n=g),
  // (k=t+4, n=g); C c0..c3 at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntiles = tile / 8;
  float* row_lo = acc + ((threadIdx.x >> 5) * 16 + g) * lda;
  float* row_hi = row_lo + 8 * lda;
  for (int it = 0; it < iters; ++it) {
    float c_big[MXU_NT_MAX][4], c_small[MXU_NT_MAX][4];
#pragma unroll
    for (int nt = 0; nt < MXU_NT_MAX; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) c_big[nt][q] = c_small[nt][q] = 0.f;
    for (int k0 = 0; k0 < tile; k0 += 8) {
      const float x[4] = {row_lo[k0 + t], row_hi[k0 + t], row_lo[k0 + t + 4],
                          row_hi[k0 + t + 4]};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a_big[q] = to_tf32(x[q]);
        a_small[q] = to_tf32(x[q] - __uint_as_float(a_big[q]));
      }
      const float* bb = b_big + (k0 + t) * ldb + g;
      const float* bs = b_small + (k0 + t) * ldb + g;
#pragma unroll
      for (int nt = 0; nt < MXU_NT_MAX; ++nt) {  // constant indices keep
        if (nt < ntiles) {                       // the sums in registers
          const uint32_t hb0 = __float_as_uint(bb[nt * 8]);
          const uint32_t hb1 = __float_as_uint(bb[nt * 8 + 4 * ldb]);
          const uint32_t lb0 = __float_as_uint(bs[nt * 8]);
          const uint32_t lb1 = __float_as_uint(bs[nt * 8 + 4 * ldb]);
          mma_tf32(c_small[nt], a_small, hb0, hb1);
          mma_tf32(c_small[nt], a_big, lb0, lb1);
          float step[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(step, a_big, hb0, hb1);
#pragma unroll
          for (int q = 0; q < 4; ++q) c_big[nt][q] += step[q];
        }
      }
    }
    __syncwarp();  // every lane has read the warp's rows of acc
#pragma unroll
    for (int nt = 0; nt < MXU_NT_MAX; ++nt) {
      if (nt < ntiles) {
        const int col = nt * 8 + 2 * t;
        row_lo[col] = c_big[nt][0] + c_small[nt][0];
        row_lo[col + 1] = c_big[nt][1] + c_small[nt][1];
        row_hi[col] = c_big[nt][2] + c_small[nt][2];
        row_hi[col + 1] = c_big[nt][3] + c_small[nt][3];
      }
    }
    __syncwarp();  // the new rows are visible to the whole warp
  }
  const int r0 = (threadIdx.x >> 5) * 16;
  for (int i = lane; i < 16 * tile; i += 32) {
    const int r = r0 + i / tile, col = i % tile;
    out[(size_t)r * tile + col] = acc[r * lda + col];
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

extern "C" int mxu_chain_launch(const void* a, const void* b, void* out,
                                int tile, int iters, void* stream) {
  if (tile < 16 || tile > MXU_MAX_TILE || tile % 16)
    return cudaErrorInvalidValue;
  const size_t smem = mxu_smem_bytes(tile);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mxu_chain_kernel<<<1, 2 * tile, smem, (cudaStream_t)stream>>>(
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
