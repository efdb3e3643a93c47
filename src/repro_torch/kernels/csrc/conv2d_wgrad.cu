// Conv filter gradient dW[F,F,D_I,D_O] = sum over (image, strip) of
// Xwin^T . dY for the H100 (sm_90a), f32.
//
// Replaces: src/repro/kernels/conv2d/bwd.py::_wgrad_dma_kernel
// (_wgrad_dma_pallas, the default "pipelined" schedule) and
// ::_wgrad_kernel (conv2d_wgrad_pallas, the "direct" schedule): both
// compute the same function, so one kernel serves both tags.
//
// What bounds it here: F*F*D_I*D_O MACs per output pixel of each image,
// against one read of X and dY and one write of dW, so at the CNN's
// widths the bound is f32 operations on the CUDA cores (67 TFLOP/s; no
// tensor cores in this first kernel).  What keeps it below that is
// shared-memory bandwidth (one X word and two dY float4s per 8 FMAs) and,
// on the TPU schedule, too few blocks: the pipelined grid is
// (D_I/bdi, D_O/bdo), one block for conv0 and 8 for conv1 on the H100's
// caps.
//
// Design: the TPU kernel folds the whole (batch, strip) sweep into each
// (d_i block, d_o stack) step and carries the dW stack in VMEM across it.
// Blocks on the H100 run in parallel and share nothing, so the sweep is
// SPLIT over `split` blocks per (d_i, d_o) pair (grid z), a number fixed
// by the shapes alone so that the grid covers the 132 SMs.  Each block
// (256 threads) keeps its F*F x bdi x bdo f32 accumulator in shared
// memory across its contiguous share of the sweep, staging each step's
// halo'd X strip [bdi][(hb-1)*S+F][W_str] and dY strip [hb*W_O][bdo] with
// cp.async, two stages deep, so the next strip's copy overlaps this
// strip's FMAs.  A thread item is one (ky, kx, d_i) x 8 output channels:
// it runs the strip's pixels in 8 registers and adds them into the
// accumulator once per step.  With split > 1 each block writes a partial
// f32 dW slab and a second kernel sums the slabs in a fixed order (no
// atomics: the result is the same on every run).  Shared memory per block,
// exactly ConvWgradPlanner's H100 budget:
//   4 * (F*F*bdi*bdo + 2*(((hb-1)*S+F)*W_str*bdi + hb*W_O*bdo)).
// Ragged channel counts need no padding: the last d_i block and d_o stack
// run over the channels that exist.  dY rows past H_O are the caller's
// zero rows and add nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCG = 8;  // output channels of one thread item

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

struct Geometry {
  int H_in, W_in, D_I, D_O, F, S, hb, W_O, n_h, bdi, bdo;
};

// Stage sweep step t = (image b, strip h): the halo'd X strip of channels
// [di0, di0+nci) -> xs[ci][r][c] and the dY strip of channels
// [do0, do0+nco) -> ds[p][co] (zeros past the stack's last channel).
__device__ __forceinline__ void load_step(const float* __restrict__ x,
                                          const float* __restrict__ dy,
                                          float* xs, float* ds,
                                          const Geometry& g, int t, int di0,
                                          int nci, int do0, int nco) {
  const int b = t / g.n_h, h = t % g.n_h;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const float* xb = x + ((size_t)b * g.H_in + (size_t)h * g.hb * g.S) * g.W_in * g.D_I;
  const int n_x = h_halo * w_str * nci;
  for (int e = threadIdx.x; e < n_x; e += kThreads) {
    const int ci = e % nci, rc = e / nci, c = rc % w_str, r = rc / w_str;
    cp_async4(xs + (ci * h_halo + r) * w_str + c,
              xb + ((size_t)r * g.W_in + c) * g.D_I + di0 + ci);
  }
  const int npix = g.hb * g.W_O;
  const float* db = dy + ((size_t)b * g.n_h + h) * npix * g.D_O;
  for (int e = threadIdx.x; e < npix * g.bdo; e += kThreads) {
    const int co = e % g.bdo, p = e / g.bdo;
    float* dst = ds + p * g.bdo + co;
    if (co < nco)
      cp_async4(dst, db + (size_t)p * g.D_O + do0 + co);
    else
      *dst = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ out, Geometry g, int steps, int split) {
  extern __shared__ __align__(16) float smem[];
  const int npix = g.hb * g.W_O, FF = g.F * g.F;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int plane = h_halo * w_str;
  const int d_stage = npix * g.bdo, x_stage = g.bdi * plane;
  // Every offset below is a multiple of 8 floats (bdo is), so the dY
  // float4 reads stay 16-byte aligned.
  float* acc = smem;                    // [F*F][bdi][bdo]
  float* ds = acc + FF * g.bdi * g.bdo;  // 2 stages of [npix][bdo]
  float* xs = ds + 2 * d_stage;          // 2 stages of [bdi][h_halo][w_str]

  const int di0 = blockIdx.x * g.bdi, do0 = blockIdx.y * g.bdo, part = blockIdx.z;
  const int nci = min(g.bdi, g.D_I - di0), nco = min(g.bdo, g.D_O - do0);
  const int ncg = (nco + kCG - 1) / kCG, items = FF * nci * ncg;
  // This block's contiguous share of the (image, strip) sweep.
  const int t0 = (int)((long long)part * steps / split);
  const int t1 = (int)((long long)(part + 1) * steps / split);

  for (int e = threadIdx.x; e < FF * g.bdi * g.bdo; e += kThreads) acc[e] = 0.f;
  load_step(x, dy, xs, ds, g, t0, di0, nci, do0, nco);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
      load_step(x, dy, xs + (s ^ 1) * x_stage, ds + (s ^ 1) * d_stage, g, t + 1,
                di0, nci, do0, nco);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = xs + s * x_stage;
    const float* dt = ds + s * d_stage;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int cg = it % ncg, q = it / ncg, ci = q % nci, kk = q / nci;
      const int ky = kk / g.F, kx = kk % g.F;
      const float* xq = xt + ci * plane + ky * w_str + kx;
      const float* dq = dt + cg * kCG;
      float r[kCG];
#pragma unroll
      for (int j = 0; j < kCG; ++j) r[j] = 0.f;
      int p = 0;
      for (int oy = 0; oy < g.hb; ++oy) {
        const float* xr = xq + oy * g.S * w_str;
#pragma unroll 4
        for (int ox = 0; ox < g.W_O; ++ox, ++p) {
          const float a = xr[ox * g.S];
          const float4 d0 = *reinterpret_cast<const float4*>(dq + p * g.bdo);
          const float4 d1 = *reinterpret_cast<const float4*>(dq + p * g.bdo + 4);
          r[0] = fmaf(a, d0.x, r[0]);
          r[1] = fmaf(a, d0.y, r[1]);
          r[2] = fmaf(a, d0.z, r[2]);
          r[3] = fmaf(a, d0.w, r[3]);
          r[4] = fmaf(a, d1.x, r[4]);
          r[5] = fmaf(a, d1.y, r[5]);
          r[6] = fmaf(a, d1.z, r[6]);
          r[7] = fmaf(a, d1.w, r[7]);
        }
      }
      float* ap = acc + (kk * g.bdi + ci) * g.bdo + cg * kCG;
#pragma unroll
      for (int j = 0; j < kCG; ++j) ap[j] += r[j];
    }
    __syncthreads();
  }

  // Flush this block's dW stack: into dW itself (split == 1) or into its
  // partial slab out[part].
  float* o = out + (size_t)part * FF * g.D_I * g.D_O;
  for (int e = threadIdx.x; e < FF * nci * nco; e += kThreads) {
    const int co = e % nco, q = e / nco, ci = q % nci, kk = q / nci;
    o[((size_t)kk * g.D_I + di0 + ci) * g.D_O + do0 + co] =
        acc[(kk * g.bdi + ci) * g.bdo + co];
  }
}

// dW[i] = sum over s of part[s][i], s in order.
__global__ void __launch_bounds__(kThreads)
    reduce_slabs_kernel(const float* __restrict__ part, float* __restrict__ out,
                        size_t n, int split) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    float v = 0.f;
    for (int s = 0; s < split; ++s) v += part[(size_t)s * n + i];
    out[i] = v;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` over a grid of (d_i blocks, d_o stacks, split); with
// split > 1 `part` holds split slabs of F*F*D_I*D_O floats and a second
// kernel reduces them into `out`.  Returns cudaGetLastError() (0 on
// success).
int repro_conv2d_wgrad_f32(const float* x, const float* dy, float* out,
                           float* part, int B, int H_in, int W_in, int D_I,
                           int D_O, int F, int S, int W_O, int n_h, int hb,
                           int bdi, int bdo, int split, void* stream) {
  const Geometry g{H_in, W_in, D_I, D_O, F, S, hb, W_O, n_h, bdi, bdo};
  const size_t h_halo = (size_t)(hb - 1) * S + F, w_str = (size_t)(W_O - 1) * S + F;
  const size_t smem = sizeof(float) * ((size_t)F * F * bdi * bdo +
                                       2 * (h_halo * w_str * bdi + (size_t)hb * W_O * bdo));
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D_I + bdi - 1) / bdi, (D_O + bdo - 1) / bdo, split);
  wgrad_f32_kernel<<<grid, kThreads, smem, st>>>(x, dy, split > 1 ? part : out, g,
                                                 B * n_h, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t n = (size_t)F * F * D_I * D_O;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 1024 ? (n + kThreads - 1) / kThreads
                                                                 : 1024);
  reduce_slabs_kernel<<<blocks, kThreads, 0, st>>>(part, out, n, split);
  return (int)cudaGetLastError();
}

}  // extern "C"
