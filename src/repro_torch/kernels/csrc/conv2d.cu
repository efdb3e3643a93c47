// Batched, strip-tiled direct conv with fused bias + ReLU + max-pool (and
// the int8 pool-argmax / ReLU-liveness mask) for the H100 (sm_90a), f32, or
// bf16 input against f32 filters and bias (the CNN's bf16 route).
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::_conv_kernel
// (conv2d_fused_pallas), the paper's Algs 1/2 with strip tiling, and, run
// on the transposed geometry with relu = 0, pool = 1 and a zero bias,
// src/repro/kernels/conv2d/bwd.py::_dgrad_dma_kernel (the input gradient).
//
// What bounds it here: a 3x3 conv at the CNN's widths does 9 * d_in MACs
// per output word, far above the card's f32 balance point (about 20
// flop/B), so the bound is f32 operations on the CUDA cores (67 TFLOP/s;
// no tensor cores). What keeps a kernel below it is shared-memory traffic
// per FMA, bank conflicts, idle threads on small planes and occupancy,
// since the planner fills one block's shared memory.
//
// One thread block (256 threads) owns one tile of (image b, strip h,
// output-channel stack do) — the Pallas grid's first three axes. The
// sequential d_in grid axis becomes a loop inside the block: each step
// stages the halo'd input strip [(hb-1)*S+F rows][W_str cols] of bdi
// channels and the filter block [F*F][bdi][bdo] in shared memory with
// cp.async, two stages deep.
//
// F = 3, S = 1, bdo a multiple of 8, bdi = 4 * 2^j (conv0-2 forward,
// conv1-3 dgrad, the all-direct plan's conv3): conv_reg_kernel<RUN>.
//   * Registers. A thread item is a run of RUN output pixels along a row
//     x 8 output channels (cg*4..+3 and bdo/2+cg*4..+3): RUN*8 f32
//     accumulators that live in registers for the block's whole d_in
//     loop. RUN (4, 8 or 16) is the shortest run that brings the items to
//     at most 256 (conv2d.py::register_layout). At stride 1 the 3-tap
//     window slides along the row in registers: each X word read from
//     shared memory feeds up to 3 taps x 8 channels, each filter float4
//     pair every pixel of the run (8-16 FMAs per shared load).
//   * Small planes. Where items < 256 (conv2-3: 128 and 32), the block
//     runs 256/items channel groups, each over its own slice of every
//     step's channels; at the end the groups' tiles are summed in group
//     order in the accumulator region (fixed, no atomics).
//   * Staging. X and the filters go in with 16-byte cp.async from the
//     NHWC operands as they lie (4-byte copies where a channel count is
//     not a multiple of 4: conv0's 3 input channels): xs[r][c][ci] with
//     each pixel's 16-byte channel chunks XOR-swizzled by
//     (c / RUN + (W_O / RUN) * r) & 3. The eight lanes of a warp that share
//     a pixel run read one word (a broadcast), and the four runs of a warp
//     are consecutive, so their four words land in four distinct banks;
//     the filter reads of a warp are two 128-byte lines.
//   * The charged accumulator term holds the groups' sum and the
//     epilogue, not deeper stages: a third stage fits only at conv1's
//     blocks, where a step's 9 K FMAs a thread outlast its 57 KB copy
//     several times over; at conv2-3 (16 and 4 KB) none fits.
// Other geometries (stride 2, other F, odd widths) run conv_simple_kernel,
// the first port's kernel: one output pixel x 8 channels a thread item for
// one step, the f32 accumulator [bdo][hb*W_O] in shared memory, 4-byte
// transposing copies.
//
// The flush (both kernels) adds the bias, applies ReLU and the
// pool x pool max-pool, and writes the int8 mask with the TPU kernel's
// encoding: the first window position holding the max (strict >), pool^2
// for a dead window (max <= 0), and with pool == 1 the ReLU liveness bit
// (0 alive, 1 dead); consecutive threads write consecutive channels.
// Shared memory per block, exactly what the planner's H100 budget charges:
//   4 * (hb*W_O*bdo + 2*(((hb-1)*S+F)*W_str*bdi + F*F*bdi*bdo)).
// Ragged channel counts need no padding: the last d_in step and the last
// output stack run over the channels that exist. Strip rows past H_O are
// computed from the caller's zero rows; the caller slices them off.
//
// bf16 input (repro_conv2d_fused_bf16xf32_bf16: the forward, writing bf16;
// ..._f32: dgrad of a bf16 dY and the recompute conv, writing f32): both
// kernels are templates on the input type TX and the output type TO. The
// filters and bias stay f32, staged as above. The input strip is staged in
// shared memory as bf16 (its four-element chunks 8-byte cp.async copies,
// at conv0's 3 channels plain 2-byte copies) and converted to f32 as it is
// read for the FMAs; the flush takes bias, ReLU, pool and mask on the f32
// sums and rounds the pooled value once (__float2bfloat16_rn) where TO is
// bf16. Shared memory is then 4*(hb*W_O*bdo + 2*F*F*bdi*bdo) +
// 2*sizeof(TX)*((hb-1)*S+F)*W_str*bdi.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kCG = 8;  // output channels of one thread item

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// Four input elements (one swizzle chunk) from device to shared memory.
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src) {
  cp_async8(dst, src);
}
// One input element (a plain copy for bf16: cp.async moves 4 bytes at least).
__device__ __forceinline__ void copy1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src) { *dst = *src; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// An f32 value stored as the output type, rounded once.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
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

// Flush one block's tile: value(pixel p, channel co) = acc[p*ps + co*cs].
// Bias, ReLU, pool x pool max-pool and the mask on the f32 values; one
// pooled word a thread, rounded once to the output type.
template <class TO>
__device__ __forceinline__ void flush(const float* acc, int ps, int cs,
                                      const float* __restrict__ bias,
                                      TO* __restrict__ out, int8_t* __restrict__ mask,
                                      const Geometry& g, int do0, int nco) {
  const int hp = g.hb / g.pool, wp = g.W_O / g.pool, pp_n = hp * wp;
  const int rows_out = gridDim.y * hp, strip = blockIdx.y, b = blockIdx.z;
  for (int e = threadIdx.x; e < nco * pp_n; e += kThreads) {
    const int co = e % nco, pp = e / nco, py = pp / wp, px = pp % wp;
    const float bv = bias[do0 + co];
    float best = -INFINITY;
    int arg = 0;
    for (int dy = 0; dy < g.pool; ++dy) {
      for (int dx = 0; dx < g.pool; ++dx) {
        const int p = (py * g.pool + dy) * g.W_O + px * g.pool + dx;
        float v = acc[p * ps + co * cs] + bv;
        if (g.relu) v = fmaxf(v, 0.f);
        if (v > best) {  // strict: ties keep the first position
          best = v;
          arg = dy * g.pool + dx;
        }
      }
    }
    const size_t o =
        (((size_t)b * rows_out + strip * hp + py) * wp + px) * g.D_O + do0 + co;
    store_out(out + o, best);
    if (mask != nullptr) {
      if (g.pool > 1)
        mask[o] = static_cast<int8_t>(best > 0.f ? arg : g.pool * g.pool);
      else
        mask[o] = static_cast<int8_t>(best > 0.f ? 0 : 1);
    }
  }
}

// ---------------------------------------------------------------------------
// The register kernel: see the header.
// ---------------------------------------------------------------------------

// The 16-byte channel chunk of pixel (r, c) that holds chunk q.
template <int RUN>
__device__ __forceinline__ int chunk_at(int q, int r, int c, int rpr, int smask) {
  return q ^ ((c / RUN + rpr * r) & smask);
}

// Stage d_in step [d0, d0+nci): the halo'd strip -> xs[r][c][ci] (pixel
// stride bdi, chunks swizzled) and the filter block -> fs[ky*3+kx][ci][co]
// (zeros past the stack's last channel). `vec`: four-element copies.
template <int RUN, class TX>
__device__ __forceinline__ void load_step_reg(const TX* __restrict__ xb,
                                              const float* __restrict__ f, TX* xs,
                                              float* fs, const Geometry& g, int row0,
                                              int d0, int nci, int do0, int nco, int rpr,
                                              int smask, bool vec) {
  const int w_str = g.W_O + 2, n_pix = (g.hb + 2) * w_str, bdi = g.bdi, bdo = g.bdo;
  if (vec) {  // D_I, D_O multiples of 4: nci and nco are too
    const unsigned qn = nci / 4;
    for (unsigned e = threadIdx.x; e < n_pix * qn; e += kThreads) {
      const unsigned q = e % qn, pix = e / qn, r = pix / w_str, c = pix % w_str;
      cp_async_quad(xs + pix * bdi + 4 * chunk_at<RUN>(q, r, c, rpr, smask),
                    xb + ((size_t)(row0 + r) * g.W_in + c) * g.D_I + d0 + 4 * q);
    }
    // Filter rows: each thread keeps one float4 column q and walks rows, so
    // the loop divides nothing (at conv3 a step's FMAs are few and a
    // division a copy would cost a third as many instructions again).
    // qo <= 256: a larger stack does not fit two stages in shared memory.
    const int qo = bdo / 4, q = threadIdx.x % qo, rstep = kThreads / qo;
    const int r0 = threadIdx.x / qo;
    if (r0 < rstep) {
      const bool live = 4 * q < nco;
      for (int kk = 0; kk < 9; ++kk) {
        const float* src = f + ((size_t)kk * g.D_I + d0) * g.D_O + do0 + 4 * q;
        float* dst = fs + kk * bdi * bdo + 4 * q;
        for (int ci = r0; ci < nci; ci += rstep) {
          if (live)
            cp_async16(dst + ci * bdo, src + (size_t)ci * g.D_O);
          else
            *reinterpret_cast<float4*>(dst + ci * bdo) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_pix * nci; e += kThreads) {
      const int ci = e % nci, pix = e / nci, r = pix / w_str, c = pix % w_str;
      copy1(xs + pix * bdi + 4 * chunk_at<RUN>(ci >> 2, r, c, rpr, smask) + (ci & 3),
            xb + ((size_t)(row0 + r) * g.W_in + c) * g.D_I + d0 + ci);
    }
    for (int e = threadIdx.x; e < 9 * nci * bdo; e += kThreads) {
      const int co = e % bdo, row = e / bdo, ci = row % nci, kk = row / nci;
      float* dst = fs + (kk * bdi + ci) * bdo + co;
      if (co < nco)
        cp_async4(dst, f + ((size_t)kk * g.D_I + d0 + ci) * g.D_O + do0 + co);
      else
        *dst = 0.f;
    }
  }
}

template <int RUN, class TX, class TO>
__global__ void __launch_bounds__(kThreads, RUN >= 8 ? 1 : 2)
    conv_reg_kernel(const TX* __restrict__ x, const float* __restrict__ f,
                    const float* __restrict__ bias, TO* __restrict__ out,
                    int8_t* __restrict__ mask, Geometry g, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int W_O = g.W_O, bdi = g.bdi, bdo = g.bdo, npix = g.hb * W_O;
  const int w_str = W_O + 2, x_stage = (g.hb + 2) * w_str * bdi, f_stage = 9 * bdi * bdo;
  // Every offset below is a multiple of 4 elements (bdo is of 8, bdi of 4).
  float* acc = smem;                                // [npix][bdo]: the groups' sum, the flush
  float* fs = acc + npix * bdo;                     // 2 stages of [9][bdi][bdo]
  TX* xs = reinterpret_cast<TX*>(fs + 2 * f_stage);  // 2 stages of [hb+2][W_O+2][bdi]

  const int do0 = blockIdx.x * bdo, b = blockIdx.z;
  const int nco = min(bdo, g.D_O - do0);
  const int ncg = bdo / kCG, rpr = W_O / RUN, items = (npix / RUN) * ncg;
  const int groups = kThreads / items, smask = min(bdi / 4, 4) - 1;
  const int tid = threadIdx.x, it = tid % items, grp = tid / items;
  const bool active = grp < groups;
  const int cg = it % ncg, run = it / ncg, oy = run / rpr, xr = run % rpr;
  const int row0 = blockIdx.y * g.hb;
  const TX* xb = x + (size_t)b * g.H_in * g.W_in * g.D_I;
  const int n_di = (g.D_I + bdi - 1) / bdi;

  float a[RUN][kCG];
#pragma unroll
  for (int p = 0; p < RUN; ++p)
#pragma unroll
    for (int j = 0; j < kCG; ++j) a[p][j] = 0.f;

  load_step_reg<RUN>(xb, f, xs, fs, g, row0, 0, min(bdi, g.D_I), do0, nco, rpr, smask, vec);
  cp_async_commit();
  for (int t = 0; t < n_di; ++t) {
    const int s = t & 1, nci = min(bdi, g.D_I - t * bdi);
    if (t + 1 < n_di) {
      const int d1 = (t + 1) * bdi;
      load_step_reg<RUN>(xb, f, xs + (s ^ 1) * x_stage, fs + (s ^ 1) * f_stage, g, row0,
                         d1, min(bdi, g.D_I - d1), do0, nco, rpr, smask, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      // This group's slice of the step's channels.
      const int per = (nci + groups - 1) / groups;
      const int c0 = grp * per, c1 = min(c0 + per, nci);
      const TX* xt = xs + s * x_stage + xr * RUN * bdi;
      const float* ft = fs + s * f_stage + cg * 4;
      for (int ci = c0; ci < c1; ++ci) {
        const int q = ci >> 2, cl = ci & 3;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int r = oy + ky;
          // Chunk offsets of this row's run (columns xr*RUN..) and of the
          // two columns past it (the next run's swizzle).
          const int o0 = 4 * (q ^ ((xr + rpr * r) & smask)) + cl;
          const int o1 = 4 * (q ^ ((xr + 1 + rpr * r) & smask)) + cl;
          const TX* xrow = xt + r * w_str * bdi;
          float xv[RUN + 2];
#pragma unroll
          for (int j = 0; j < RUN + 2; ++j)
            xv[j] = to_f32(xrow[j * bdi + (j < RUN ? o0 : o1)]);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* fr = ft + ((ky * 3 + kx) * bdi + ci) * bdo;
            const float4 w0 = *reinterpret_cast<const float4*>(fr);
            const float4 w1 = *reinterpret_cast<const float4*>(fr + bdo / 2);
            const float wv[kCG] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < RUN; ++p)
#pragma unroll
              for (int j = 0; j < kCG; ++j) a[p][j] = fmaf(xv[p + kx], wv[j], a[p][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // The groups' tiles, summed in group order into acc[pixel][channel].
  const int pix0 = oy * W_O + xr * RUN;
  for (int q = 0; q < groups; ++q) {
    if (active && grp == q) {
#pragma unroll
      for (int p = 0; p < RUN; ++p) {
        float4* d0 = reinterpret_cast<float4*>(acc + (pix0 + p) * bdo + cg * 4);
        float4* d1 = reinterpret_cast<float4*>(acc + (pix0 + p) * bdo + bdo / 2 + cg * 4);
        float4 v0 = make_float4(a[p][0], a[p][1], a[p][2], a[p][3]);
        float4 v1 = make_float4(a[p][4], a[p][5], a[p][6], a[p][7]);
        if (q > 0) {
          const float4 u0 = *d0, u1 = *d1;
          v0.x += u0.x; v0.y += u0.y; v0.z += u0.z; v0.w += u0.w;
          v1.x += u1.x; v1.y += u1.y; v1.z += u1.z; v1.w += u1.w;
        }
        *d0 = v0;
        *d1 = v1;
      }
    }
    __syncthreads();
  }
  flush(acc, bdo, 1, bias, out, mask, g, do0, nco);
}

// ---------------------------------------------------------------------------
// The simple kernel: any F, S and blocks (shared-memory accumulator)
// ---------------------------------------------------------------------------

// Stage d_in step [d0, d0+nci): the halo'd strip -> xs[ci][r][c] and the
// filter block -> fs[ky*F+kx][ci][co] (zeros past the stack's last channel).
template <class TX>
__device__ __forceinline__ void load_step(const TX* __restrict__ xb,
                                          const float* __restrict__ f,
                                          TX* xs, float* fs,
                                          const Geometry& g, int row0, int d0,
                                          int nci, int do0, int nco) {
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int n_x = h_halo * w_str * nci;
  for (int e = threadIdx.x; e < n_x; e += kThreads) {
    const int ci = e % nci, rc = e / nci, c = rc % w_str, r = rc / w_str;
    copy1(xs + (ci * h_halo + r) * w_str + c,
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

template <class TX, class TO>
__global__ void __launch_bounds__(kThreads)
    conv_simple_kernel(const TX* __restrict__ x, const float* __restrict__ f,
                       const float* __restrict__ bias, TO* __restrict__ out,
                       int8_t* __restrict__ mask, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int npix = g.hb * g.W_O;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int x_stage = g.bdi * h_halo * w_str, f_stage = g.F * g.F * g.bdi * g.bdo;
  // Every offset below is a multiple of 8 floats (bdo is), so the
  // filter's float4 reads stay 16-byte aligned.
  float* acc = smem;                                // [bdo][npix]
  float* fs = acc + g.bdo * npix;                   // 2 stages of [F*F][bdi][bdo]
  TX* xs = reinterpret_cast<TX*>(fs + 2 * f_stage);  // 2 stages of [bdi][h_halo][w_str]

  const int do0 = blockIdx.x * g.bdo, strip = blockIdx.y, b = blockIdx.z;
  const int nco = min(g.bdo, g.D_O - do0);
  const int ncg = (nco + kCG - 1) / kCG;
  const int row0 = strip * g.hb * g.S;
  const TX* xb = x + (size_t)b * g.H_in * g.W_in * g.D_I;
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
    const TX* xt = xs + s * x_stage;
    const float* ft = fs + s * f_stage;
    for (int it = threadIdx.x; it < ncg * npix; it += kThreads) {
      const int cg = it / npix, p = it % npix;
      const int oy = p / g.W_O, ox = p % g.W_O;
      const TX* xp = xt + oy * g.S * w_str + ox * g.S;
      const float* fp = ft + cg * kCG;
      float r[kCG];
#pragma unroll
      for (int j = 0; j < kCG; ++j) r[j] = 0.f;
      for (int ky = 0; ky < g.F; ++ky) {
        for (int kx = 0; kx < g.F; ++kx) {
          const TX* xq = xp + ky * w_str + kx;
          const float* fq = fp + (ky * g.F + kx) * g.bdi * g.bdo;
#pragma unroll 4
          for (int ci = 0; ci < nci; ++ci) {
            const float a = to_f32(xq[ci * plane]);
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
  flush(acc, 1, npix, bias, out, mask, g, do0, nco);
}

template <int RUN, class TX, class TO>
cudaError_t launch_reg(dim3 grid, size_t smem, cudaStream_t st, const TX* x,
                       const float* f, const float* bias, TO* out, int8_t* mask,
                       const Geometry& g, int vec) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_reg_kernel<RUN, TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_reg_kernel<RUN, TX, TO><<<grid, kThreads, smem, st>>>(x, f, bias, out, mask, g, vec);
  return cudaGetLastError();
}

template <class TX, class TO>
int launch(const TX* x, const float* f, const float* bias, TO* out, int8_t* mask, int B,
           int H_in, int W_in, int D_I, int D_O, int F, int S, int W_O, int n_h, int hb,
           int bdi, int bdo, int relu, int pool, int run, void* stream) {
  const Geometry g{H_in, W_in, D_I, D_O, F, S, hb, W_O, bdi, bdo, pool, relu};
  const size_t h_halo = (size_t)(hb - 1) * S + F, w_str = (size_t)(W_O - 1) * S + F;
  const size_t smem = sizeof(float) * ((size_t)hb * W_O * bdo + 2 * (size_t)F * F * bdi * bdo) +
                      2 * sizeof(TX) * h_halo * w_str * bdi;
  const dim3 grid((D_O + bdo - 1) / bdo, n_h, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = D_I % 4 == 0 && D_O % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)f % 16 == 0;
  switch (run) {
    case 4: return (int)launch_reg<4>(grid, smem, st, x, f, bias, out, mask, g, vec);
    case 8: return (int)launch_reg<8>(grid, smem, st, x, f, bias, out, mask, g, vec);
    case 16: return (int)launch_reg<16>(grid, smem, st, x, f, bias, out, mask, g, vec);
    default: break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv_simple_kernel<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_simple_kernel<TX, TO><<<grid, kThreads, smem, st>>>(x, f, bias, out, mask, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` over a grid of (output stacks, strips, images); `mask`
// may be null. `run` (from conv2d.py::register_layout) selects the register
// kernel with runs of 4, 8 or 16 pixels, 0 the simple kernel. Returns
// cudaGetLastError() (0 on success).
int repro_conv2d_fused_f32(const float* x, const float* f, const float* bias,
                           float* out, int8_t* mask, int B, int H_in, int W_in,
                           int D_I, int D_O, int F, int S, int W_O, int n_h,
                           int hb, int bdi, int bdo, int relu, int pool, int run,
                           void* stream) {
  return launch<float, float>(x, f, bias, out, mask, B, H_in, W_in, D_I, D_O, F, S, W_O,
                              n_h, hb, bdi, bdo, relu, pool, run, stream);
}

// bf16 x against f32 filters and bias, writing bf16 (the forward).
int repro_conv2d_fused_bf16xf32_bf16(const bf16* x, const float* f, const float* bias,
                                     bf16* out, int8_t* mask, int B, int H_in, int W_in,
                                     int D_I, int D_O, int F, int S, int W_O, int n_h,
                                     int hb, int bdi, int bdo, int relu, int pool, int run,
                                     void* stream) {
  return launch<bf16, bf16>(x, f, bias, out, mask, B, H_in, W_in, D_I, D_O, F, S, W_O, n_h,
                            hb, bdi, bdo, relu, pool, run, stream);
}

// bf16 x against f32 filters and bias, writing f32 (dgrad, the recompute conv).
int repro_conv2d_fused_bf16xf32_f32(const bf16* x, const float* f, const float* bias,
                                    float* out, int8_t* mask, int B, int H_in, int W_in,
                                    int D_I, int D_O, int F, int S, int W_O, int n_h,
                                    int hb, int bdi, int bdo, int relu, int pool, int run,
                                    void* stream) {
  return launch<bf16, float>(x, f, bias, out, mask, B, H_in, W_in, D_I, D_O, F, S, W_O,
                             n_h, hb, bdi, bdo, relu, pool, run, stream);
}

}  // extern "C"
