// The FC layer's backward matmuls for the H100 (sm_90a), f32:
//   NT     dX[M,K] = dY[M,N] . W[K,N]^T             (repro_matmul_nt_f32)
//   TN     dW[K,N] = X[M,K]^T . dY[M,N]             (repro_matmul_tn_f32)
//   fused  both from one read of each dY tile       (repro_matmul_dxdw_f32)
//
// Replaces: src/repro/kernels/matmul/bwd.py::_mm_nt_kernel
// (matmul_nt_pallas), ::_mm_tn_kernel (matmul_tn_pallas) and
// ::_mm_dxdw_kernel (matmul_dx_dw_pallas).
//
// What bounds them here: at the CNN's FC shapes (fc1 256x2048x4096, fc2
// 256x4096x1000) the arithmetic intensity is far above the card's f32
// balance point (about 20 flop/B), so the bound is f32 operations on the
// CUDA cores (67 TFLOP/s; no tensor cores in these first kernels).  What
// keeps them below it is shared-memory bandwidth and small grids: the
// schedules' tiles give 64 to 256 blocks for the pair and one block per
// k-block (16 or 32) for the fused kernel.
//
// Design: the microkernel of matmul.cu (256 threads, a 4 x 8 register item
// per thread per step, the f32 accumulator in shared memory), applied to
// operands staged in shared memory with cp.async, two stages deep.
//   * NT: one block per dX tile [bm][bk]; the N axis (the contraction) is
//     the loop.  Each step stages the dY tile [bm][bn] and the W tile
//     W[k0:k0+bk, n0:n0+bn], which lands transposed in shared memory
//     ([bn][bk], 4-byte copies), so no W^T ever exists in device memory.
//   * TN: one block per dW tile [bk][bn]; the M axis is the loop.  Each
//     step stages X[m0:m0+bm, k0:k0+bk] and dY[m0:m0+bm, n0:n0+bn] as they
//     lie and contracts over their shared row axis.
//   * fused: one block per k-block.  It loops n-blocks and, inside them,
//     m-blocks; each step stages one dY tile, the W tile (transposed) and
//     the X tile, and feeds the dY tile to both contractions.  The whole-M
//     dX strip [M][bk] and the dW tile [bk][bn] stay in shared memory: the
//     dW tile flushes after each n-block, the dX strip once at the end.
// Shared memory per block is exactly what the planners charge:
//   NT 4*(bm*bk + 2*(bm*bn + bn*bk)), TN 4*(bk*bn + 2*(bm*bk + bm*bn)),
//   fused 4*(2*(bm*bn + bk*bn + bm*bk) + M*bk + bk*bn).
// Contract (checked by the Python wrappers): M, N, K multiples of the
// blocks; blocks multiples of 8; 16-byte aligned, contiguous row-major
// operands.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // rows of one thread item
constexpr int kTN = 8;  // columns of one thread item: two runs of 4, cols/2 apart

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// src[r0:r0+rows, c0:c0+cols] of a row-major matrix with row length ld
// -> dst[rows][cols], 16 bytes per copy.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int ld, int r0, int c0, int rows, int cols) {
  const int q = cols / 4;
  for (int e = threadIdx.x; e < rows * q; e += kThreads) {
    const int r = e / q, c = (e % q) * 4;
    cp_async16(dst + r * cols + c, src + (size_t)(r0 + r) * ld + c0 + c);
  }
}

// W[k0:k0+bk, n0:n0+bn] (row length N) -> dst[bn][bk], transposed.  Eight
// neighbouring threads read one 32-byte run of a W row.
__device__ __forceinline__ void stage_t(float* dst, const float* __restrict__ W,
                                        int N, int k0, int n0, int bk, int bn) {
  for (int e = threadIdx.x; e < bk * bn; e += kThreads) {
    const int c = (e / (8 * bk)) * 8 + e % 8, r = (e / 8) % bk;
    cp_async4(dst + c * bk + r, W + (size_t)(k0 + r) * N + n0 + c);
  }
}

// acc[rows][ldc] += A . B with A(i, kk) = a[i*a_rs + kk*a_ks] and
// B(kk, j) = b[kk*ldb + j]; rows a multiple of 4, cols of 8.
__device__ __forceinline__ void mma_tile(float* acc, int ldc, const float* a,
                                         int a_rs, int a_ks, const float* b,
                                         int ldb, int rows, int cols, int depth) {
  const int half = cols / 2, groups = cols / kTN, items = (rows / kTM) * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int mi = it / groups, nj = it % groups;
    const float* ar = a + mi * kTM * a_rs;
    const float* bc = b + nj * 4;
    float r[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) r[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(bc + kk * ldb);
      const float4 b1 = *reinterpret_cast<const float4*>(bc + kk * ldb + half);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = ar[i * a_rs + kk * a_ks];
        r[i][0] = fmaf(av, b0.x, r[i][0]);
        r[i][1] = fmaf(av, b0.y, r[i][1]);
        r[i][2] = fmaf(av, b0.z, r[i][2]);
        r[i][3] = fmaf(av, b0.w, r[i][3]);
        r[i][4] = fmaf(av, b1.x, r[i][4]);
        r[i][5] = fmaf(av, b1.y, r[i][5]);
        r[i][6] = fmaf(av, b1.z, r[i][6]);
        r[i][7] = fmaf(av, b1.w, r[i][7]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float4* p0 = reinterpret_cast<float4*>(acc + (mi * kTM + i) * ldc + nj * 4);
      float4* p1 = reinterpret_cast<float4*>(acc + (mi * kTM + i) * ldc + nj * 4 + half);
      float4 v0 = *p0, v1 = *p1;
      v0.x += r[i][0]; v0.y += r[i][1]; v0.z += r[i][2]; v0.w += r[i][3];
      v1.x += r[i][4]; v1.y += r[i][5]; v1.z += r[i][6]; v1.w += r[i][7];
      *p0 = v0;
      *p1 = v1;
    }
  }
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) p[e] = 0.f;
}

// dst[r0:r0+rows, c0:c0+cols] (row length ld) = src[rows][cols].
__device__ __forceinline__ void flush(float* __restrict__ dst, int ld, int r0, int c0,
                                      const float* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
    dst[(size_t)(r0 + r) * ld + c0 + c] = src[e];
  }
}

__global__ void __launch_bounds__(kThreads)
    mm_nt_kernel(const float* __restrict__ G, const float* __restrict__ W,
                 float* __restrict__ DX, int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;             // [bm][bk]
  float* gs = acc + bm * bk;     // 2 stages of [bm][bn]
  float* ws = gs + 2 * bm * bn;  // 2 stages of [bn][bk] (W tile transposed)
  const int k0 = blockIdx.x * bk, m0 = blockIdx.y * bm, n_n = N / bn;

  zero(acc, bm * bk);
  stage(gs, G, N, m0, 0, bm, bn);
  stage_t(ws, W, N, k0, 0, bk, bn);
  cp_async_commit();
  for (int t = 0; t < n_n; ++t) {
    const int s = t & 1;
    if (t + 1 < n_n) {
      stage(gs + (s ^ 1) * bm * bn, G, N, m0, (t + 1) * bn, bm, bn);
      stage_t(ws + (s ^ 1) * bn * bk, W, N, k0, (t + 1) * bn, bk, bn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_tile(acc, bk, gs + s * bm * bn, bn, 1, ws + s * bn * bk, bk, bm, bk, bn);
    __syncthreads();
  }
  flush(DX, K, m0, k0, acc, bm, bk);
}

__global__ void __launch_bounds__(kThreads)
    mm_tn_kernel(const float* __restrict__ X, const float* __restrict__ G,
                 float* __restrict__ DW, int M, int N, int K, int bm, int bn,
                 int bk) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;             // [bk][bn]
  float* xs = acc + bk * bn;     // 2 stages of [bm][bk]
  float* gs = xs + 2 * bm * bk;  // 2 stages of [bm][bn]
  const int n0 = blockIdx.x * bn, k0 = blockIdx.y * bk, n_m = M / bm;

  zero(acc, bk * bn);
  stage(xs, X, K, 0, k0, bm, bk);
  stage(gs, G, N, 0, n0, bm, bn);
  cp_async_commit();
  for (int t = 0; t < n_m; ++t) {
    const int s = t & 1;
    if (t + 1 < n_m) {
      stage(xs + (s ^ 1) * bm * bk, X, K, (t + 1) * bm, k0, bm, bk);
      stage(gs + (s ^ 1) * bm * bn, G, N, (t + 1) * bm, n0, bm, bn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_tile(acc, bn, xs + s * bm * bk, 1, bk, gs + s * bm * bn, bn, bk, bn, bm);
    __syncthreads();
  }
  flush(DW, N, k0, n0, acc, bk, bn);
}

__global__ void __launch_bounds__(kThreads)
    mm_dxdw_kernel(const float* __restrict__ G, const float* __restrict__ W,
                   const float* __restrict__ X, float* __restrict__ DX,
                   float* __restrict__ DW, int M, int N, int K, int bm, int bn,
                   int bk) {
  extern __shared__ __align__(16) float smem[];
  float* dxs = smem;                     // [M][bk] whole-M dX strip
  float* dws = dxs + M * bk;             // [bk][bn] dW tile
  float* gs = dws + bk * bn;             // 2 stages of [bm][bn]
  float* ws = gs + 2 * bm * bn;          // 2 stages of [bn][bk] (W transposed)
  float* xs = ws + 2 * bn * bk;          // 2 stages of [bm][bk]
  const int k0 = blockIdx.x * bk, n_m = M / bm, steps = (N / bn) * n_m;

  zero(dxs, M * bk);
  zero(dws, bk * bn);
  stage(gs, G, N, 0, 0, bm, bn);
  stage_t(ws, W, N, k0, 0, bk, bn);
  stage(xs, X, K, 0, k0, bm, bk);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    const int s = t & 1, nb = t / n_m, mb = t % n_m;
    if (t + 1 < steps) {
      const int n1 = ((t + 1) / n_m) * bn, m1 = ((t + 1) % n_m) * bm;
      stage(gs + (s ^ 1) * bm * bn, G, N, m1, n1, bm, bn);
      stage_t(ws + (s ^ 1) * bn * bk, W, N, k0, n1, bk, bn);
      stage(xs + (s ^ 1) * bm * bk, X, K, m1, k0, bm, bk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* gt = gs + s * bm * bn;
    // dX rows of this m-block += dY tile . W tile^T (contract N) ...
    mma_tile(dxs + mb * bm * bk, bk, gt, bn, 1, ws + s * bn * bk, bk, bm, bk, bn);
    // ... and dW tile += X tile^T . the same dY tile (contract M).
    mma_tile(dws, bn, xs + s * bm * bk, 1, bk, gt, bn, bk, bn, bm);
    __syncthreads();
    if (mb == n_m - 1) {  // the dW tile of this n-block is complete
      for (int e = threadIdx.x; e < bk * bn; e += kThreads) {
        const int r = e / bn, c = e % bn;
        DW[(size_t)(k0 + r) * N + nb * bn + c] = dws[e];
        dws[e] = 0.f;
      }
    }
  }
  __syncthreads();
  flush(DX, K, 0, k0, dxs, M, bk);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success).

int repro_matmul_nt_f32(const float* G, const float* W, float* DX, int M, int N,
                        int K, int bm, int bn, int bk, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)bm * bk + 2 * ((size_t)bm * bn + (size_t)bn * bk));
  cudaError_t err = set_smem((const void*)mm_nt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K / bk, M / bm);
  mm_nt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      G, W, DX, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

int repro_matmul_tn_f32(const float* X, const float* G, float* DW, int M, int N,
                        int K, int bm, int bn, int bk, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)bk * bn + 2 * ((size_t)bm * bk + (size_t)bm * bn));
  cudaError_t err = set_smem((const void*)mm_tn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / bn, K / bk);
  mm_tn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, G, DW, M, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

int repro_matmul_dxdw_f32(const float* G, const float* W, const float* X, float* DX,
                          float* DW, int M, int N, int K, int bm, int bn, int bk,
                          void* stream) {
  const size_t smem = sizeof(float) * (2 * ((size_t)bm * bn + (size_t)bk * bn + (size_t)bm * bk) +
                                       (size_t)M * bk + (size_t)bk * bn);
  cudaError_t err = set_smem((const void*)mm_dxdw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mm_dxdw_kernel<<<K / bk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      G, W, X, DX, DW, M, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // extern "C"
