// Conv filter gradient dW[F,F,D_I,D_O] = sum over (image, strip) of
// Xwin^T . dY for the H100 (sm_90a), f32 or bf16 X and dY, f32 dW.
//
// Replaces: src/repro/kernels/conv2d/bwd.py::_wgrad_dma_kernel
// (_wgrad_dma_pallas, the default "pipelined" schedule) and
// ::_wgrad_kernel (conv2d_wgrad_pallas, the "direct" schedule): both
// compute the same function, so one kernel serves both tags.
//
// What bounds it here: as a GEMM it has F*F*D_I rows and D_O columns and
// contracts over the B*H_O*W_O output pixels, so at the CNN's widths the
// bound is f32 operations on the CUDA cores (67 TFLOP/s; no tensor cores).
// What keeps a kernel below that is shared-memory traffic per FMA, the
// accumulator's home, and too few resident warps.
//
// Design (the register kernel, F = 3, bdi a multiple of 4, at most 256
// thread items): the TPU kernel folds the (batch, strip) sweep into each
// (d_i block, d_o stack) step and carries the dW stack in VMEM. Here the
// sweep is SPLIT over `split` blocks per (d_i, d_o) pair (grid z), a
// number fixed by the shapes alone (bwd.py::wgrad_split) so that the grid
// fills the resident block slots of the 132 SMs.
//   * Registers. A thread item is one input channel x 8 output channels
//     with all F*F taps: 72 f32 accumulators that live in registers for
//     the block's whole share of the sweep. Along an output row the taps
//     kx = 0..F-1 of neighbouring pixels read the same X columns, so at
//     stride 1 a 3 x 3 window slides in registers: each X word read from
//     shared memory feeds 3 taps x 8 channels = 24 FMAs, each dY float4
//     feeds 9 taps x 4 channels = 36.
//   * Pixel groups. bdi * bdo/8 items (128 at the CNN's 16/64 blocks) fill
//     256 threads as 256/items pixel groups; each group runs every
//     (256/items)-th output row of a stage, and at the end the groups' tiles
//     are summed in group order (fixed, no atomics) in the accumulator
//     region, which then stages coalesced 16-byte stores of dW.
//   * Staging. X and dY are copied with 16-byte cp.async in the NHWC order
//     they lie in (xs[r][c][ci], ds[p][co]); the wrapper pads channel
//     counts to multiples of 4. During the sweep the accumulator region is
//     free, so the whole allocation holds two stages of G (image, strip)
//     steps each, G as large as fits: short steps (conv3's 16 pixels) then
//     share one pair of barriers.
// Shared memory per block is exactly ConvWgradPlanner's H100 budget:
//   4 * (F*F*bdi*bdo + 2*(((hb-1)*S+F)*W_str*bdi + hb*W_O*bdo)),
// the accumulator term serving the epilogue and the stream terms the
// stages. Blocks the register kernel does not take (other F, bdi not a
// multiple of 4, more than 256 items) run the simple kernel below, which
// keeps the accumulator in shared memory and adds one step's registers
// into it. With split > 1 each block writes a partial f32 dW slab and a
// second kernel sums the slabs in a fixed order, so two launches on the
// same inputs give the same bits. dY rows past H_O are the caller's zero
// rows and add nothing.
//
// bf16 (repro_conv2d_wgrad_bf16: the CNN's bf16 route, X and dY both bf16,
// as repro's backward hands them to its wgrad kernel): both kernels are
// templates on the operand type T. Each four-element unit of the f32
// kernels (a 16-byte cp.async, a float4 read) is four bf16 (an 8-byte
// cp.async, an 8-byte read), the 4-byte copies of the simple kernel plain
// 2-byte copies, so every thread mapping, stage and loop is the f32
// kernel's; the operands sit in shared memory as bf16 and are converted to
// f32 as they are read for the FMAs. The accumulators, the partial slabs
// and dW stay f32. Shared memory: 4*F*F*bdi*bdo + 2*sizeof(T)*(X strip +
// dY strip), the planner's H100 term at two bytes an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// Four elements from device to shared memory.
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src) {
  cp_async8(dst, src);
}
// One element from device to shared memory (a plain copy for bf16).
__device__ __forceinline__ void copy1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src) { *dst = *src; }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16_rn(0.f); }
// Four elements of shared memory, as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
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

// This block's contiguous share [t0, t1) of the (image, strip) sweep.
__device__ __forceinline__ void sweep_share(int steps, int split, int* t0, int* t1) {
  *t0 = (int)((long long)blockIdx.z * steps / split);
  *t1 = (int)((long long)(blockIdx.z + 1) * steps / split);
}

// ---------------------------------------------------------------------------
// The register kernel
// ---------------------------------------------------------------------------

// Stage sweep step t = (image b, strip h) with four-element copies: the
// halo'd X strip of channels [di0, di0+nci) -> xs[r][c][ci] (row of bdi
// elements) and the dY strip of channels [do0, do0+nco) -> ds[p][co] (row
// of bdo).
template <class T>
__device__ __forceinline__ void load_step16(const T* __restrict__ x,
                                            const T* __restrict__ dy, T* xs,
                                            T* ds, const Geometry& g, int t,
                                            int di0, int nci, int do0, int nco) {
  // Unsigned index arithmetic: a division by a runtime value is half the
  // instructions of the signed one.
  const unsigned b = (unsigned)t / g.n_h, h = (unsigned)t % g.n_h;
  const unsigned h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const T* xb = x + ((size_t)b * g.H_in + (size_t)h * g.hb * g.S) * g.W_in * g.D_I + di0;
  const unsigned qx = nci / 4, n_x = h_halo * w_str * qx;
  for (unsigned e = threadIdx.x; e < n_x; e += kThreads) {
    const unsigned q = e % qx, rc = e / qx, c = rc % w_str, r = rc / w_str;
    cp_async_quad(xs + (r * w_str + c) * g.bdi + 4 * q,
                  xb + ((size_t)r * g.W_in + c) * g.D_I + 4 * q);
  }
  const unsigned npix = g.hb * g.W_O, qd = nco / 4;
  const T* db = dy + ((size_t)b * g.n_h + h) * npix * g.D_O + do0;
  for (unsigned e = threadIdx.x; e < npix * qd; e += kThreads) {
    const unsigned q = e % qd, p = e / qd;
    cp_async_quad(ds + p * g.bdo + 4 * q, db + (size_t)p * g.D_O + 4 * q);
  }
}

template <int F, class T>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_reg_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ out, Geometry g, int steps, int split,
                     int group_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int S = g.S, W_O = g.W_O, bdi = g.bdi, bdo = g.bdo;
  const int h_halo = (g.hb - 1) * S + F, w_str = (W_O - 1) * S + F;
  const int x_step = h_halo * w_str * bdi, step_f = x_step + g.hb * W_O * bdo;
  const int di0 = blockIdx.x * bdi, do0 = blockIdx.y * bdo;
  const int nci = min(bdi, g.D_I - di0), nco = min(bdo, g.D_O - do0);
  const int ncg = (nco + kCG - 1) / kCG, items = nci * ncg;
  const int groups = kThreads / items;
  const int item = threadIdx.x % items, grp = threadIdx.x / items;
  const bool active = grp < groups;
  const int ci = item % nci, cg = item / nci;
  const int G = group_steps;  // (image, strip) steps per stage
  // Stage s of the two starts at smem + s * G * step_f (computed, not held
  // in an array, so the loads below stay shared-memory loads).

  // dY columns past the stack's last channel stay zero in every stage.
  if (nco < ncg * kCG)
    for (int e = threadIdx.x; e < 2 * G * g.hb * W_O; e += kThreads) {
      T* row = smem + (e / (g.hb * W_O)) * step_f + x_step + (e % (g.hb * W_O)) * bdo;
      for (int co = nco; co < ncg * kCG; ++co) row[co] = zero_of<T>();
    }

  float acc[F][F][kCG];
#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j)
#pragma unroll
      for (int c = 0; c < kCG; ++c) acc[i][j][c] = 0.f;

  int t0, t1;
  sweep_share(steps, split, &t0, &t1);
  const int n_chunks = (t1 - t0 + G - 1) / G;
  auto stage_chunk = [&](int chunk) {
    T* st = smem + (chunk & 1) * G * step_f;
    const int first = t0 + chunk * G, cnt = min(G, t1 - first);
    for (int j = 0; j < cnt; ++j)
      load_step16(x, dy, st + j * step_f, st + j * step_f + x_step, g, first + j, di0,
                  nci, do0, nco);
    cp_async_commit();
  };
  if (n_chunks > 0) stage_chunk(0);
  const int row_x = w_str * bdi;  // elements between X rows
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      stage_chunk(chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = smem + (chunk & 1) * G * step_f;
    const int rows = min(G, t1 - t0 - chunk * G) * g.hb;
    if (active) {
      for (int rr = grp; rr < rows; rr += groups) {
        const int j = rr / g.hb, oy = rr % g.hb;
        const T* xr = st + j * step_f + oy * S * row_x + ci;
        const T* dr = st + j * step_f + x_step + oy * W_O * bdo + cg * kCG;
        if (S == 1) {
          // A window of F x F X words slides along the row in registers.
          float w[F][F];
#pragma unroll
          for (int ky = 0; ky < F; ++ky)
#pragma unroll
            for (int kx = 0; kx < F - 1; ++kx) w[ky][kx] = to_f32(xr[ky * row_x + kx * bdi]);
#pragma unroll 2
          for (int ox = 0; ox < W_O; ++ox) {
#pragma unroll
            for (int ky = 0; ky < F; ++ky)
              w[ky][F - 1] = to_f32(xr[ky * row_x + (ox + F - 1) * bdi]);
            const float4 d0 = ld4(dr + ox * bdo);
            const float4 d1 = ld4(dr + ox * bdo + 4);
            const float d[kCG] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
            for (int ky = 0; ky < F; ++ky)
#pragma unroll
              for (int kx = 0; kx < F; ++kx)
#pragma unroll
                for (int c = 0; c < kCG; ++c)
                  acc[ky][kx][c] = fmaf(w[ky][kx], d[c], acc[ky][kx][c]);
#pragma unroll
            for (int ky = 0; ky < F; ++ky)
#pragma unroll
              for (int kx = 0; kx < F - 1; ++kx) w[ky][kx] = w[ky][kx + 1];
          }
        } else {
          for (int ox = 0; ox < W_O; ++ox) {
            const float4 d0 = ld4(dr + ox * bdo);
            const float4 d1 = ld4(dr + ox * bdo + 4);
            const float d[kCG] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
            const T* xc = xr + ox * S * bdi;
#pragma unroll
            for (int ky = 0; ky < F; ++ky)
#pragma unroll
              for (int kx = 0; kx < F; ++kx) {
                const float a = to_f32(xc[ky * row_x + kx * bdi]);
#pragma unroll
                for (int c = 0; c < kCG; ++c) acc[ky][kx][c] = fmaf(a, d[c], acc[ky][kx][c]);
              }
          }
        }
      }
    }
    __syncthreads();
  }

  // The groups' tiles, summed in group order into the accumulator region
  // red[F*F][bdi][bdo] (the stages are no longer read).
  float* red = reinterpret_cast<float*>(smem_raw);
  for (int q = 0; q < groups; ++q) {
    if (active && grp == q) {
#pragma unroll
      for (int ky = 0; ky < F; ++ky)
#pragma unroll
        for (int kx = 0; kx < F; ++kx) {
          float4* p = reinterpret_cast<float4*>(
              red + ((ky * F + kx) * bdi + ci) * bdo + cg * kCG);
          float4 v0 = make_float4(acc[ky][kx][0], acc[ky][kx][1], acc[ky][kx][2],
                                  acc[ky][kx][3]);
          float4 v1 = make_float4(acc[ky][kx][4], acc[ky][kx][5], acc[ky][kx][6],
                                  acc[ky][kx][7]);
          if (q > 0) {
            const float4 o0 = p[0], o1 = p[1];
            v0.x += o0.x; v0.y += o0.y; v0.z += o0.z; v0.w += o0.w;
            v1.x += o1.x; v1.y += o1.y; v1.z += o1.z; v1.w += o1.w;
          }
          p[0] = v0;
          p[1] = v1;
        }
    }
    __syncthreads();
  }

  // Flush with 16-byte stores: into dW itself (split == 1) or into this
  // block's partial slab out[z]. nco is a multiple of 4.
  float* o = out + (size_t)blockIdx.z * F * F * g.D_I * g.D_O;
  const int q4 = nco / 4;
  for (int e = threadIdx.x; e < F * F * nci * q4; e += kThreads) {
    const int q = e % q4, r = e / q4, c = r % nci, kk = r / nci;
    *reinterpret_cast<float4*>(o + ((size_t)kk * g.D_I + di0 + c) * g.D_O + do0 + 4 * q) =
        *reinterpret_cast<const float4*>(red + (kk * bdi + c) * bdo + 4 * q);
  }
}

// ---------------------------------------------------------------------------
// The simple kernel: any F, S and blocks (shared-memory accumulator)
// ---------------------------------------------------------------------------

// Stage sweep step t with one-element copies: X -> xs[ci][r][c], dY ->
// ds[p][co] (zeros past the stack's last channel).
template <class T>
__device__ __forceinline__ void load_step4(const T* __restrict__ x,
                                           const T* __restrict__ dy, T* xs,
                                           T* ds, const Geometry& g, int t, int di0,
                                           int nci, int do0, int nco) {
  const int b = t / g.n_h, h = t % g.n_h;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const T* xb = x + ((size_t)b * g.H_in + (size_t)h * g.hb * g.S) * g.W_in * g.D_I;
  const int n_x = h_halo * w_str * nci;
  for (int e = threadIdx.x; e < n_x; e += kThreads) {
    const int ci = e % nci, rc = e / nci, c = rc % w_str, r = rc / w_str;
    copy1(xs + (ci * h_halo + r) * w_str + c,
          xb + ((size_t)r * g.W_in + c) * g.D_I + di0 + ci);
  }
  const int npix = g.hb * g.W_O;
  const T* db = dy + ((size_t)b * g.n_h + h) * npix * g.D_O;
  for (int e = threadIdx.x; e < npix * g.bdo; e += kThreads) {
    const int co = e % g.bdo, p = e / g.bdo;
    T* dst = ds + p * g.bdo + co;
    if (co < nco)
      copy1(dst, db + (size_t)p * g.D_O + do0 + co);
    else
      *dst = zero_of<T>();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    wgrad_simple_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        float* __restrict__ out, Geometry g, int steps, int split) {
  extern __shared__ __align__(16) float smem[];
  const int npix = g.hb * g.W_O, FF = g.F * g.F;
  const int h_halo = (g.hb - 1) * g.S + g.F, w_str = (g.W_O - 1) * g.S + g.F;
  const int plane = h_halo * w_str;
  const int d_stage = npix * g.bdo, x_stage = g.bdi * plane;
  float* acc = smem;                                          // [F*F][bdi][bdo]
  T* ds = reinterpret_cast<T*>(acc + FF * g.bdi * g.bdo);     // 2 stages of [npix][bdo]
  T* xs = ds + 2 * d_stage;                                   // 2 stages of [bdi][h_halo][w_str]

  const int di0 = blockIdx.x * g.bdi, do0 = blockIdx.y * g.bdo;
  const int nci = min(g.bdi, g.D_I - di0), nco = min(g.bdo, g.D_O - do0);
  const int ncg = (nco + kCG - 1) / kCG, items = FF * nci * ncg;
  int t0, t1;
  sweep_share(steps, split, &t0, &t1);

  for (int e = threadIdx.x; e < FF * g.bdi * g.bdo; e += kThreads) acc[e] = 0.f;
  if (t0 < t1) load_step4(x, dy, xs, ds, g, t0, di0, nci, do0, nco);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
      load_step4(x, dy, xs + (s ^ 1) * x_stage, ds + (s ^ 1) * d_stage, g, t + 1, di0,
                 nci, do0, nco);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xt = xs + s * x_stage;
    const T* dt = ds + s * d_stage;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int cg = it % ncg, q = it / ncg, ci = q % nci, kk = q / nci;
      const int ky = kk / g.F, kx = kk % g.F;
      const T* xq = xt + ci * plane + ky * w_str + kx;
      const T* dq = dt + cg * kCG;
      float r[kCG];
#pragma unroll
      for (int j = 0; j < kCG; ++j) r[j] = 0.f;
      int p = 0;
      for (int oy = 0; oy < g.hb; ++oy) {
        const T* xr = xq + oy * g.S * w_str;
#pragma unroll 4
        for (int ox = 0; ox < g.W_O; ++ox, ++p) {
          const float a = to_f32(xr[ox * g.S]);
          const float4 d0 = ld4(dq + p * g.bdo);
          const float4 d1 = ld4(dq + p * g.bdo + 4);
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

  float* o = out + (size_t)blockIdx.z * FF * g.D_I * g.D_O;
  for (int e = threadIdx.x; e < FF * nci * nco; e += kThreads) {
    const int co = e % nco, q = e / nco, ci = q % nci, kk = q / nci;
    o[((size_t)kk * g.D_I + di0 + ci) * g.D_O + do0 + co] =
        acc[(kk * g.bdi + ci) * g.bdo + co];
  }
}

// dW[i] = sum over s of part[s][i], s in order, four floats a thread.
__global__ void __launch_bounds__(kThreads)
    reduce_slabs_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                        size_t n4, int split) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kThreads) {
    float4 v = part[i];
    for (int s = 1; s < split; ++s) {
      const float4 p = part[(size_t)s * n4 + i];
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    out[i] = v;
  }
}

template <class T>
int launch(const T* x, const T* dy, float* out, float* part, int B, int H_in, int W_in,
           int D_I, int D_O, int F, int S, int W_O, int n_h, int hb, int bdi, int bdo,
           int split, void* stream) {
  const Geometry g{H_in, W_in, D_I, D_O, F, S, hb, W_O, n_h, bdi, bdo};
  const size_t h_halo = (size_t)(hb - 1) * S + F, w_str = (size_t)(W_O - 1) * S + F;
  const size_t step_e = h_halo * w_str * bdi + (size_t)hb * W_O * bdo;  // elements
  const size_t smem = sizeof(float) * (size_t)F * F * bdi * bdo + 2 * sizeof(T) * step_e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D_I + bdi - 1) / bdi, (D_O + bdo - 1) / bdo, split);
  float* dst = split > 1 ? part : out;
  const bool reg = F == 3 && bdi % 4 == 0 && bdi * ((bdo + kCG - 1) / kCG) <= kThreads;
  cudaError_t err;
  if (reg) {
    const int group_steps = (int)(smem / (2 * sizeof(T) * step_e));
    err = cudaFuncSetAttribute(wgrad_reg_kernel<3, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    wgrad_reg_kernel<3, T><<<grid, kThreads, smem, st>>>(x, dy, dst, g, B * n_h, split,
                                                         group_steps);
  } else {
    err = cudaFuncSetAttribute(wgrad_simple_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    wgrad_simple_kernel<T><<<grid, kThreads, smem, st>>>(x, dy, dst, g, B * n_h, split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t n4 = (size_t)F * F * D_I * D_O / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  reduce_slabs_kernel<<<(int)(want < 1024 ? want : 1024), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), n4, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` over a grid of (d_i blocks, d_o stacks, split); with
// split > 1 `part` holds split slabs of F*F*D_I*D_O floats and a second
// kernel reduces them into `out`. D_I and D_O are multiples of 4 (the
// wrapper pads them). Returns cudaGetLastError() (0 on success).
int repro_conv2d_wgrad_f32(const float* x, const float* dy, float* out, float* part,
                           int B, int H_in, int W_in, int D_I, int D_O, int F, int S,
                           int W_O, int n_h, int hb, int bdi, int bdo, int split,
                           void* stream) {
  return launch<float>(x, dy, out, part, B, H_in, W_in, D_I, D_O, F, S, W_O, n_h, hb, bdi,
                       bdo, split, stream);
}

// The same for bf16 X and dY (f32 accumulators, slabs and dW).
int repro_conv2d_wgrad_bf16(const bf16* x, const bf16* dy, float* out, float* part, int B,
                            int H_in, int W_in, int D_I, int D_O, int F, int S, int W_O,
                            int n_h, int hb, int bdi, int bdo, int split, void* stream) {
  return launch<bf16>(x, dy, out, part, B, H_in, W_in, D_I, D_O, F, S, W_O, n_h, hb, bdi,
                      bdo, split, stream);
}

}  // extern "C"
