// Batched, strip-tiled direct conv with fused bias + ReLU + max-pool (and
// the int8 pool-argmax / ReLU-liveness mask) for the H100 (sm_90a), f32.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::_conv_kernel
// (conv2d_fused_pallas), the paper's Algs 1/2 with strip tiling.
//
// What bounds it here: a 3x3 conv at the CNN's widths does 9 * d_in MACs
// per output word, far above the card's f32 balance point (about 20
// flop/B), so the bound is f32 operations on the CUDA cores (67 TFLOP/s;
// no tensor cores in this first kernel).  What keeps it below that is
// shared-memory bandwidth (one input word and two filter float4s per 8
// FMAs) and occupancy, since the planner fills one block's shared memory.
//
// Design: one thread block (256 threads) owns one tile of (image b, strip
// h, output-channel stack do) — the Pallas grid's first three axes.  The
// sequential d_in grid axis becomes a loop inside the block: each step
// stages the halo'd input strip [(hb-1)*S+F rows][W_str cols] of bdi
// channels (channel-major, so neighbouring output pixels read neighbouring
// words) and the filter block [F*F][bdi][bdo] in shared memory with
// cp.async, two stages deep.  The f32 accumulator [bdo][hb*W_O] stays in
// shared memory across the whole d_in loop (the Pallas acc_ref).  Each
// thread item is one output pixel x 8 output channels: the F^2 shifted,
// strided products over the step's channels run in 8 registers and are
// added into the accumulator once per step.  The flush adds the bias,
// applies ReLU and the pool x pool max-pool, and writes the int8 mask with
// the TPU kernel's encoding: the first window position holding the max,
// pool^2 for a dead window (max <= 0), and with pool == 1 the ReLU
// liveness bit (0 alive, 1 dead).  Shared memory per block, exactly what
// the planner's H100 budget charges:
//   4 * (hb*W_O*bdo + 2*(((hb-1)*S+F)*W_str*bdi + F*F*bdi*bdo)).
// Ragged channel counts need no padding: the last d_in step and the last
// output stack run over the channels that exist.  Strip rows past H_O are
// computed from the caller's zero rows; the caller slices them off.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  int H_in, W_in, D_I, D_O, F, S, hb, W_O, bdi, bdo, pool, relu;
};

// Stage d_in step [d0, d0+nci): the halo'd strip -> xs[ci][r][c] and the
// filter block -> fs[ky*F+kx][ci][co] (zeros past the stack's last channel).
__device__ __forceinline__ void load_step(const float* __restrict__ xb,
                                          const float* __restrict__ f,
                                          float* xs, float* fs,
                                          const Geometry& g, int row0, int d0,
                                          int nci, int do0, int nco) {
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int n_x = h_halo * w_str * nci;
  for (int e = threadIdx.x; e < n_x; e += kThreads) {
    const int ci = e % nci, rc = e / nci, c = rc % w_str, r = rc / w_str;
    cp_async4(xs + (ci * h_halo + r) * w_str + c,
              xb + ((size_t)(row0 + r) * g.W_in + c) * g.D_I + d0 + ci);
  }
  const int n_f = g.F * g.F * nci * g.bdo;
  for (int e = threadIdx.x; e < n_f; e += kThreads) {
    const int co = e % g.bdo, q = e / g.bdo, ci = q % nci, kk = q / nci;
    float* dst = fs + (kk * g.bdi + ci) * g.bdo + co;
    if (co < nco)
      cp_async4(dst, f + ((size_t)kk * g.D_I + d0 + ci) * g.D_O + do0 + co);
    else
      *dst = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ f,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int8_t* __restrict__ mask, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int npix = g.hb * g.W_O;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int x_stage = g.bdi * h_halo * w_str, f_stage = g.F * g.F * g.bdi * g.bdo;
  // Every offset below is a multiple of 8 floats (bdo is), so the
  // filter's float4 reads stay 16-byte aligned.
  float* acc = smem;                 // [bdo][npix]
  float* fs = acc + g.bdo * npix;    // 2 stages of [F*F][bdi][bdo]
  float* xs = fs + 2 * f_stage;      // 2 stages of [bdi][h_halo][w_str]

  const int do0 = blockIdx.x * g.bdo, strip = blockIdx.y, b = blockIdx.z;
  const int nco = min(g.bdo, g.D_O - do0);
  const int ncg = (nco + kCG - 1) / kCG;
  const int row0 = strip * g.hb * g.S;
  const float* xb = x + (size_t)b * g.H_in * g.W_in * g.D_I;
  const int n_di = (g.D_I + g.bdi - 1) / g.bdi;
  const int plane = h_halo * w_str;

  for (int e = threadIdx.x; e < g.bdo * npix; e += kThreads) acc[e] = 0.f;
  load_step(xb, f, xs, fs, g, row0, 0, min(g.bdi, g.D_I), do0, nco);
  cp_async_commit();

  for (int t = 0; t < n_di; ++t) {
    const int s = t & 1;
    const int nci = min(g.bdi, g.D_I - t * g.bdi);
    if (t + 1 < n_di) {
      const int d1 = (t + 1) * g.bdi;
      load_step(xb, f, xs + (s ^ 1) * x_stage, fs + (s ^ 1) * f_stage, g, row0,
                d1, min(g.bdi, g.D_I - d1), do0, nco);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = xs + s * x_stage;
    const float* ft = fs + s * f_stage;
    for (int it = threadIdx.x; it < ncg * npix; it += kThreads) {
      const int cg = it / npix, p = it % npix;
      const int oy = p / g.W_O, ox = p % g.W_O;
      const float* xp = xt + oy * g.S * w_str + ox * g.S;
      const float* fp = ft + cg * kCG;
      float r[kCG];
#pragma unroll
      for (int j = 0; j < kCG; ++j) r[j] = 0.f;
      for (int ky = 0; ky < g.F; ++ky) {
        for (int kx = 0; kx < g.F; ++kx) {
          const float* xq = xp + ky * w_str + kx;
          const float* fq = fp + (ky * g.F + kx) * g.bdi * g.bdo;
#pragma unroll 4
          for (int ci = 0; ci < nci; ++ci) {
            const float a = xq[ci * plane];
            const float4 w0 = *reinterpret_cast<const float4*>(fq + ci * g.bdo);
            const float4 w1 = *reinterpret_cast<const float4*>(fq + ci * g.bdo + 4);
            r[0] = fmaf(a, w0.x, r[0]);
            r[1] = fmaf(a, w0.y, r[1]);
            r[2] = fmaf(a, w0.z, r[2]);
            r[3] = fmaf(a, w0.w, r[3]);
            r[4] = fmaf(a, w1.x, r[4]);
            r[5] = fmaf(a, w1.y, r[5]);
            r[6] = fmaf(a, w1.z, r[6]);
            r[7] = fmaf(a, w1.w, r[7]);
          }
        }
      }
      float* ap = acc + cg * kCG * npix + p;
#pragma unroll
      for (int j = 0; j < kCG; ++j) ap[j * npix] += r[j];
    }
    __syncthreads();
  }

  // Flush: bias, ReLU, pool x pool max-pool, mask; one pooled word each.
  const int hp = g.hb / g.pool, wp = g.W_O / g.pool, pp_n = hp * wp;
  const int rows_out = gridDim.y * hp;
  for (int e = threadIdx.x; e < nco * pp_n; e += kThreads) {
    const int pp = e % pp_n, co = e / pp_n, py = pp / wp, px = pp % wp;
    const float bv = bias[do0 + co];
    const float* ac = acc + co * npix;
    float best = -INFINITY;
    int arg = 0;
    for (int dy = 0; dy < g.pool; ++dy) {
      for (int dx = 0; dx < g.pool; ++dx) {
        float v = ac[(py * g.pool + dy) * g.W_O + px * g.pool + dx] + bv;
        if (g.relu) v = fmaxf(v, 0.f);
        if (v > best) {  // strict: ties keep the first position
          best = v;
          arg = dy * g.pool + dx;
        }
      }
    }
    const size_t o =
        (((size_t)b * rows_out + strip * hp + py) * wp + px) * g.D_O + do0 + co;
    out[o] = best;
    if (mask != nullptr) {
      if (g.pool > 1)
        mask[o] = static_cast<int8_t>(best > 0.f ? arg : g.pool * g.pool);
      else
        mask[o] = static_cast<int8_t>(best > 0.f ? 0 : 1);
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` over a grid of (output stacks, strips, images); `mask`
// may be null.  Returns cudaGetLastError() (0 on success).
int repro_conv2d_fused_f32(const float* x, const float* f, const float* bias,
                           float* out, int8_t* mask, int B, int H_in, int W_in,
                           int D_I, int D_O, int F, int S, int W_O, int n_h,
                           int hb, int bdi, int bdo, int relu, int pool,
                           void* stream) {
  const Geometry g{H_in, W_in, D_I, D_O, F, S, hb, W_O, bdi, bdo, pool, relu};
  const size_t h_halo = (size_t)(hb - 1) * S + F, w_str = (size_t)(W_O - 1) * S + F;
  const size_t smem = sizeof(float) * ((size_t)hb * W_O * bdo +
                                       2 * (h_halo * w_str * bdi + (size_t)F * F * bdi * bdo));
  cudaError_t err = cudaFuncSetAttribute(
      conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D_O + bdo - 1) / bdo, n_h, B);
  conv_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, f, bias, out, mask, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
