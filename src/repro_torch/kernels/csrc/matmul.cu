// Blocked f32 matmul O[M,N] = X[M,K] . W[K,N] for the H100 (sm_90a).
//
// Replaces: src/repro/kernels/matmul/matmul.py::_mm_kernel (matmul_pallas),
// the FC forward of the CNN and the GEMM core of the im2col conv.
//
// What bounds it here: at the main path's shapes (fc1 256x2048x4096, fc2
// 256x4096x1000, im2col strips with K = 9*d_in) the arithmetic intensity
// is well above the card's f32 balance point (67 TFLOP/s over 3.35 TB/s,
// about 20 flop/B), so the bound is f32 operations.  This first kernel
// issues plain FMAs on the CUDA cores (no tensor cores), so 67 TFLOP/s is
// its ceiling; what keeps it below that is shared-memory bandwidth and
// too few thread blocks on small grids.
//
// Design: one thread block (256 threads) owns one bm x bn output tile —
// the Pallas kernel's (i, j) grid point.  The sequential K grid axis of the
// TPU kernel becomes a loop inside the block: each bk-deep step stages an
// X tile [bm][bk] and a W tile [bk][bn] in shared memory with cp.async,
// two stages deep, so the next step's copy overlaps this step's FMAs.  The
// f32 accumulator tile [bm][bn] also lives in shared memory for the whole
// loop (the Pallas acc_ref) and is written to O once.  Registers hold one
// 4 x 8 item of partial sums per thread for one step: each step reads X and
// W from shared memory once per item and adds its 32 sums into the
// accumulator once, so the accumulator costs one read-modify-write per bk
// FMAs.  The planner's H100 budget (core/machine.py) is exactly these
// shared-memory bytes: 4 * (bm*bn + 2*(bm*bk + bk*bn)).
//
// Contract (checked by the Python wrapper): M, N, K multiples of bm, bn, bk;
// bm, bn, bk multiples of 8; 16-byte aligned, contiguous row-major operands.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // rows of one thread item
constexpr int kTN = 8;  // columns of one thread item: two runs of 4, bn/2 apart

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage one K step: X[m0:m0+bm, k0:k0+bk] -> xs[bm][bk] and
// W[k0:k0+bk, n0:n0+bn] -> ws[bk][bn], 16 bytes per copy.
__device__ __forceinline__ void load_step(const float* __restrict__ X,
                                          const float* __restrict__ W,
                                          float* xs, float* ws, int K, int N,
                                          int m0, int n0, int k0, int bm,
                                          int bn, int bk) {
  const int xq = bk / 4;
  for (int e = threadIdx.x; e < bm * xq; e += kThreads) {
    const int r = e / xq, c = (e % xq) * 4;
    cp_async16(xs + r * bk + c, X + (size_t)(m0 + r) * K + k0 + c);
  }
  const int wq = bn / 4;
  for (int e = threadIdx.x; e < bk * wq; e += kThreads) {
    const int r = e / wq, c = (e % wq) * 4;
    cp_async16(ws + r * bn + c, W + (size_t)(k0 + r) * N + n0 + c);
  }
}

__global__ void __launch_bounds__(kThreads)
    mm_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                  float* __restrict__ O, int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;               // [bm][bn] f32 accumulator
  float* xs = acc + bm * bn;       // 2 stages of [bm][bk]
  float* ws = xs + 2 * bm * bk;    // 2 stages of [bk][bn]
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int half = bn / 2, groups = bn / kTN, items = (bm / kTM) * groups;
  const int n_k = K / bk;

  for (int e = threadIdx.x; e < bm * bn; e += kThreads) acc[e] = 0.f;
  load_step(X, W, xs, ws, K, N, m0, n0, 0, bm, bn, bk);
  cp_async_commit();

  for (int t = 0; t < n_k; ++t) {
    const int s = t & 1;
    if (t + 1 < n_k) {
      load_step(X, W, xs + (s ^ 1) * bm * bk, ws + (s ^ 1) * bk * bn, K, N,
                m0, n0, (t + 1) * bk, bm, bn, bk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = xs + s * bm * bk;
    const float* wt = ws + s * bk * bn;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int mi = it / groups, nj = it % groups;
      const float* xr = xt + mi * kTM * bk;
      const float* wc = wt + nj * 4;
      float r[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) r[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < bk; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(wc + kk * bn);
        const float4 b1 = *reinterpret_cast<const float4*>(wc + kk * bn + half);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float a = xr[i * bk + kk];
          r[i][0] = fmaf(a, b0.x, r[i][0]);
          r[i][1] = fmaf(a, b0.y, r[i][1]);
          r[i][2] = fmaf(a, b0.z, r[i][2]);
          r[i][3] = fmaf(a, b0.w, r[i][3]);
          r[i][4] = fmaf(a, b1.x, r[i][4]);
          r[i][5] = fmaf(a, b1.y, r[i][5]);
          r[i][6] = fmaf(a, b1.z, r[i][6]);
          r[i][7] = fmaf(a, b1.w, r[i][7]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float4* p0 = reinterpret_cast<float4*>(acc + (mi * kTM + i) * bn + nj * 4);
        float4* p1 = reinterpret_cast<float4*>(acc + (mi * kTM + i) * bn + nj * 4 + half);
        float4 v0 = *p0, v1 = *p1;
        v0.x += r[i][0]; v0.y += r[i][1]; v0.z += r[i][2]; v0.w += r[i][3];
        v1.x += r[i][4]; v1.y += r[i][5]; v1.z += r[i][6]; v1.w += r[i][7];
        *p0 = v0;
        *p1 = v1;
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
    const int r = e / bn, c = e % bn;
    O[(size_t)(m0 + r) * N + n0 + c] = acc[e];
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int repro_matmul_f32(const float* X, const float* W, float* O, int M, int N,
                     int K, int bm, int bn, int bk, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)bm * bn + 2 * ((size_t)bm * bk + (size_t)bk * bn));
  cudaError_t err = cudaFuncSetAttribute(
      mm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / bn, M / bm);
  mm_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      X, W, O, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // extern "C"
