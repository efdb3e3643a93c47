// Blocked matmul O[M,N] = X[M,K] . W[K,N] for the H100 (sm_90a), f32 or
// bf16 operands, f32 accumulator, the output in the operands' type.
//
// Replaces: src/repro/kernels/matmul/matmul.py::_mm_kernel (matmul_pallas),
// the FC forward of the CNN, the GEMM core of the im2col conv and every
// forward GEMM of the transformer step.
//
// What bounds the f32 route here: at the main path's shapes (fc1 256x2048x4096, fc2
// 256x4096x1000, im2col strips with K = 9*d_in, the transformer's M = 8192
// and logits 2048x1024x151936) the arithmetic intensity is well above the
// card's f32 balance point (67 TFLOP/s over 3.35 TB/s, about 20 flop/B),
// so the bound is f32 operations on the CUDA cores (no tensor cores). What
// keeps a kernel below it is shared-memory traffic per FMA, bank conflicts,
// and grids under one wave of SMs.
//
// At the planner's tile (bm 64, bn 128, bk 32; every forward GEMM of both
// training steps), f32 and the mixed routes run mm_reg_kernel:
//   * Registers. 256 threads, each a 4 x 8 tile of O (rows mi*4..+3,
//     columns kj*4..+3 and 64+kj*4..+3) in registers for the block's whole
//     K loop. Per contraction index it reads three float4s from shared
//     memory for 32 FMAs; a warp's reads are four X chunks and two runs of
//     eight W chunks, each within one 128-byte line.
//   * Staging. X has K, the contraction, along its row, so its tile is
//     transposed on the way in: each thread loads two float4s of X rows
//     from device memory (eight threads cover one 128-byte run of a row)
//     into registers during the current step's FMAs and writes them
//     contraction-major, xs[bk][bm], with the row XOR-swizzled by
//     ((k >> 2) & 7) << 2: the 32 scalar stores of a warp land in 32
//     distinct banks and the float4 reads stay whole. W's tile [bk][bn] is
//     contraction-major already and goes in as it lies, with 16-byte
//     cp.async. The charged [bm][bn] accumulator region is free until the
//     epilogue, so the whole allocation holds a ring of three stages: W's
//     copies run two steps ahead, X's one, with one barrier a step.
//   * Epilogue. The register tiles go to the first bm*bn floats of the
//     allocation and leave as coalesced 16-byte stores.
//   * Small grids. Where the (n, m) grid is under one wave of SMs (fc1,
//     fc2), the K loop is split over a number of blocks fixed by the shapes
//     (matmul.py::mm_split); each writes a partial f32 slab and a second
//     kernel sums the slabs in order, so the result is the same on every
//     run.
// The wrapper picks the kernel (matmul.py::template) and passes it in `reg`;
// other tiles run mm_simple_kernel (the first port's kernel, with the same
// split): a 4 x 8 register item a step, the f32 accumulator tile [bm][bn]
// in shared memory, X and W staged as they lie with cp.async, two stages
// deep. Shared memory per block is exactly the planner's H100 budget term:
// 4 * (bm*bn + 2*(bm*bk + bk*bn)).
//
//
// bf16 (repro_matmul_bf16) at the planner's tile: mm_wgmma_kernel
// (gemm_sm90.cuh), on the tensor cores. It replaces _mm_kernel on the path
// repro trains in bf16; its bound is the tensor cores' 989 TFLOP/s (every
// call on the path is far above bf16's 295 flop/B balance point). X is a
// K-major A tile and W an MN-major B tile (two 64-column halves with the
// 128-byte swizzle) of wgmma m64n128k16, copied by TMA into a four-stage
// ring in the planner's 57,344 B; the f32 tile lives in registers, the
// CUDA cores add it into a second register tile every few steps, and it is
// rounded once (__float2bfloat16_rn) as it is stored. The wrapper names it
// (matmul.py::template "wgmma", `reg` 2); nothing else takes bf16 at that
// tile. ptxas (nvcc 12.9): 136 registers, no spills.
// Other tiles run mm_simple_kernel on bf16: every four-element unit of the
// f32 kernel (a float4, a 16-byte cp.async) is four bf16 of 8 bytes, the
// operand tiles sit in shared memory as bf16 and are converted to f32 as
// they are read for the FMAs. Shared memory per block is the planner's
// H100 term at the operands' size: 4*bm*bn + 2*sizeof(T)*(bm*bk + bk*bn).
// Split partial slabs stay f32 and the ordered sum rounds once.
//
// bf16 X against f32 W (repro_matmul_bf16xf32_bf16 / _f32: the CNN's fc1
// and its im2col patch GEMM at compute_dtype bf16, where repro's type
// promotion keeps the weights f32): the kernels are templates on X's, W's
// and O's types. Each operand is read from device memory and staged in
// shared memory in its own type (X in 8-byte quads, W in 16-byte float4s,
// each as its one-type kernel stages it), converted to f32 as it leaves
// shared memory; the output is O's type (bf16 for fc1, f32 for the patch
// GEMM, whose bias, ReLU and pool run on the f32 sums). Shared memory is
// 4*bm*bn + 2*(sizeof(TX)*bm*bk + sizeof(TW)*bk*bn).
//
// Contract (checked by the Python wrapper): M, N, K multiples of bm, bn, bk;
// bm, bn, bk multiples of 8; 16-byte aligned, contiguous row-major operands
// of one type, or bf16 X against f32 W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTM = 4;  // rows of one thread item
constexpr int kTN = 8;  // columns of one thread item: two runs of 4, bn/2 apart

// Four consecutive operand elements: a float4, or four bf16 in 8 bytes.
struct __align__(8) bf16x4 {
  bf16 v[4];
};
template <class T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<bf16> {
  using type = bf16x4;
};
template <class T>
using quad_t = typename Quad<T>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}
__device__ __forceinline__ bf16 elem(const bf16x4& q, int j) { return q.v[j]; }

// Four elements of shared memory, as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const bf16x4 q = *reinterpret_cast<const bf16x4*>(p);
  return make_float4(__bfloat162float(q.v[0]), __bfloat162float(q.v[1]),
                     __bfloat162float(q.v[2]), __bfloat162float(q.v[3]));
}
// Four elements of device memory through the read-only path.
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ bf16x4 ldg4(const bf16* p) {
  union {
    uint2 u;
    bf16x4 q;
  } r;
  r.u = __ldg(reinterpret_cast<const uint2*>(p));
  return r.q;
}
// Four floats stored as four elements of the output type.
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  bf16x4 q;
  q.v[0] = __float2bfloat16_rn(v.x);
  q.v[1] = __float2bfloat16_rn(v.y);
  q.v[2] = __float2bfloat16_rn(v.z);
  q.v[3] = __float2bfloat16_rn(v.w);
  *reinterpret_cast<bf16x4*>(p) = q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
// Four elements from device to shared memory.
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src) {
  cp_async8(dst, src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The K steps [t0, t1) of split part blockIdx.z.
__device__ __forceinline__ void split_share(int n_steps, int split, int* t0, int* t1) {
  *t0 = (int)((long long)blockIdx.z * n_steps / split);
  *t1 = (int)((long long)(blockIdx.z + 1) * n_steps / split);
}

// ---------------------------------------------------------------------------
// The register kernel: see the header.
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 128, kBK = 32, kStages = 3;
constexpr int kXs = kBK * kBM, kWs = kBK * kBN;  // elements of a stage's X, W tile
// Bytes of one stage of the ring: the X tile, then the W tile.
template <class TX, class TW>
__host__ __device__ constexpr size_t stage_bytes() {
  return sizeof(TX) * kXs + sizeof(TW) * kWs;
}

__device__ __forceinline__ int k_swz(int k) { return ((k >> 2) & 7) << 2; }

// The output tile from the f32 staging tile acc[bm][ld]: to this part's f32
// slab of P where the K loop is split, else rounded once to O's type.
// Coalesced four-element stores.
template <class TO>
__device__ __forceinline__ void store_tile(TO* __restrict__ O, float* __restrict__ P,
                                           const float* acc, int ld, int M, int N, int m0,
                                           int n0, int bm, int bn, int split) {
  for (int e = threadIdx.x; e < bm * bn / 4; e += kThreads) {
    const int row = e / (bn / 4), c4 = e % (bn / 4);
    const float4 v = ld4(acc + row * ld + c4 * 4);
    const size_t at = (size_t)(m0 + row) * N + n0 + c4 * 4;
    if (split > 1)
      st4(P + (size_t)blockIdx.z * M * N + at, v);
    else
      st4(O + at, v);
  }
}

template <class TX, class TW, class TO>
__global__ void __launch_bounds__(kThreads, 2)
    mm_reg_kernel(const TX* __restrict__ X, const TW* __restrict__ W, TO* __restrict__ O,
                  float* __restrict__ P, int M, int N, int K, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr size_t kStageB = stage_bytes<TX, TW>();
  // Stage s: xs[bk][bm] (swizzled) at byte s*kStageB, ws[bk][bn] after it.
  auto xs_at = [&](int s) { return reinterpret_cast<TX*>(smem_raw + s * kStageB); };
  auto ws_at = [&](int s) {
    return reinterpret_cast<TW*>(smem_raw + s * kStageB + sizeof(TX) * kXs);
  };
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = (warp >> 1) * 4 + (lane >> 3);  // 0..15: rows mi*4..+3
  const int kj = (warp & 1) * 8 + (lane & 7);    // 0..15: cols kj*4.., 64+kj*4..
  int t0, t1;
  split_share(K / kBK, split, &t0, &t1);
  const int n_t = t1 - t0;

  // X loader roles: rows lr and lr+32 of the tile, four-element column lc.
  const int lr = tid >> 3, lc = tid & 7;
  const TX* xsrc = X + (size_t)(m0 + lr) * K + lc * 4;
  quad_t<TX> rx[2];
  auto load_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) rx[i] = ldg4(xsrc + (size_t)i * 32 * K + t * kBK);
  };
  auto store_x = [&](int s) {
    TX* xs = xs_at(s);
    const int sw = lc << 2;  // k_swz(k) for k = lc*4 + j
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = (lr + 32 * i) ^ sw;
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[(lc * 4 + j) * kBM + c] = elem(rx[i], j);
    }
  };
  auto stage_w = [&](int t, int s) {
    TW* ws = ws_at(s);
    const TW* src = W + (size_t)t * kBK * N + n0;
#pragma unroll
    for (int i = 0; i < kWs / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 5, c4 = e & 31;
      cp_async_quad(ws + r * kBN + c4 * 4, src + (size_t)r * N + c4 * 4);
    }
  };

  float r[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) r[i][j] = 0.f;

  if (n_t > 0) stage_w(t0, 0);
  cp_async_commit();
  if (n_t > 1) stage_w(t0 + 1, 1);
  cp_async_commit();
  if (n_t > 0) {
    load_x(t0);
    store_x(0);
  }
  cp_async_wait<1>();
  __syncthreads();
  int s = 0;  // the stage of step i; the ring is kStages deep
  for (int i = 0; i < n_t; ++i) {
    const int s1 = s + 1 == kStages ? 0 : s + 1, s2 = s1 + 1 == kStages ? 0 : s1 + 1;
    if (i + 2 < n_t) stage_w(t0 + i + 2, s2);
    cp_async_commit();
    if (i + 1 < n_t) load_x(t0 + i + 1);  // in flight during this step's FMAs
    const TX* xs = xs_at(s);
    const TW* ws = ws_at(s);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const int sw = k_swz(kk);
      const float4 a = ld4(xs + kk * kBM + ((mi * 4) ^ sw));
      const float4 b0 = ld4(ws + kk * kBN + kj * 4);
      const float4 b1 = ld4(ws + kk * kBN + 64 + kj * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
        for (int j = 0; j < kTN; ++j) r[ii][j] = fmaf(av[ii], bv[j], r[ii][j]);
    }
    if (i + 1 < n_t) store_x(s1);
    cp_async_wait<1>();  // step i+1's W has landed; step i+2's may be in flight
    __syncthreads();
    s = s1;
  }
  cp_async_wait<0>();

  // Registers -> the first bm*bn floats -> the O tile (or this part's slab).
  float* acc = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* row = acc + (mi * kTM + i) * kBN;
    *reinterpret_cast<float4*>(row + kj * 4) = make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
    *reinterpret_cast<float4*>(row + 64 + kj * 4) =
        make_float4(r[i][4], r[i][5], r[i][6], r[i][7]);
  }
  __syncthreads();
  store_tile(O, P, acc, kBN, M, N, m0, n0, kBM, kBN, split);
}

// ---------------------------------------------------------------------------
// The simple kernel: any blocks (shared-memory accumulator)
// ---------------------------------------------------------------------------

// Stage one K step: X[m0:m0+bm, k0:k0+bk] -> xs[bm][bk] and
// W[k0:k0+bk, n0:n0+bn] -> ws[bk][bn], four elements per copy.
template <class TX, class TW>
__device__ __forceinline__ void load_step(const TX* __restrict__ X, const TW* __restrict__ W,
                                          TX* xs, TW* ws, int K, int N, int m0, int n0,
                                          int k0, int bm, int bn, int bk) {
  const int xq = bk / 4;
  for (int e = threadIdx.x; e < bm * xq; e += kThreads) {
    const int r = e / xq, c = (e % xq) * 4;
    cp_async_quad(xs + r * bk + c, X + (size_t)(m0 + r) * K + k0 + c);
  }
  const int wq = bn / 4;
  for (int e = threadIdx.x; e < bk * wq; e += kThreads) {
    const int r = e / wq, c = (e % wq) * 4;
    cp_async_quad(ws + r * bn + c, W + (size_t)(k0 + r) * N + n0 + c);
  }
}

template <class TX, class TW, class TO>
__global__ void __launch_bounds__(kThreads)
    mm_simple_kernel(const TX* __restrict__ X, const TW* __restrict__ W, TO* __restrict__ O,
                     float* __restrict__ P, int M, int N, int K, int bm, int bn, int bk,
                     int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);   // [bm][bn] f32 accumulator
  TX* xs = reinterpret_cast<TX*>(acc + bm * bn);      // 2 stages of [bm][bk]
  TW* ws = reinterpret_cast<TW*>(xs + 2 * bm * bk);   // 2 stages of [bk][bn]
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int half = bn / 2, groups = bn / kTN, items = (bm / kTM) * groups;
  int t0, t1;
  split_share(K / bk, split, &t0, &t1);

  for (int e = threadIdx.x; e < bm * bn; e += kThreads) acc[e] = 0.f;
  if (t0 < t1) load_step(X, W, xs, ws, K, N, m0, n0, t0 * bk, bm, bn, bk);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
      load_step(X, W, xs + (s ^ 1) * bm * bk, ws + (s ^ 1) * bk * bn, K, N, m0, n0,
                (t + 1) * bk, bm, bn, bk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TX* xt = xs + s * bm * bk;
    const TW* wt = ws + s * bk * bn;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int mi = it / groups, nj = it % groups;
      const TX* xr = xt + mi * kTM * bk;
      const TW* wc = wt + nj * 4;
      float r[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) r[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < bk; ++kk) {
        const float4 b0 = ld4(wc + kk * bn);
        const float4 b1 = ld4(wc + kk * bn + half);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float a = to_f32(xr[i * bk + kk]);
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

  store_tile(O, P, acc, bn, M, N, m0, n0, bm, bn, split);
}

// out[i] = sum over s of part[s][i], s in order, four floats a thread, the
// sum rounded once to the output type.
template <class TO>
__global__ void __launch_bounds__(kThreads)
    reduce_slabs_kernel(const float4* __restrict__ part, TO* __restrict__ out, size_t n4,
                        int split) {
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kThreads) {
    float4 v = part[i];
    for (int s = 1; s < split; ++s) {
      const float4 p = part[(size_t)s * n4 + i];
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    st4(out + 4 * i, v);
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The kernel a launch's `reg` names (matmul.py::template).
enum Template { kSimple = 0, kRegister = 1, kWgmma = 2 };

template <class TX, class TW, class TO>
int launch(const TX* X, const TW* W, TO* O, float* part, int M, int N, int K, int bm,
           int bn, int bk, int split, int reg, void* stream) {
  constexpr bool kBf16 = std::is_same<TX, bf16>::value && std::is_same<TW, bf16>::value;
  const size_t smem = sizeof(float) * (size_t)bm * bn +
                      2 * (sizeof(TX) * (size_t)bm * bk + sizeof(TW) * (size_t)bk * bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / bn, M / bm, split);
  cudaError_t err;
  if (reg != kSimple) {
    if (bm != kBM || bn != kBN || bk != kBK || reg != (kBf16 ? kWgmma : kRegister))
      return (int)cudaErrorInvalidValue;
    if constexpr (kBf16) {
      static_assert(sm90::kBM == kBM && sm90::kBN == kBN && sm90::kBK == kBK &&
                        sm90::kSmemNeeded <= 4 * kBM * kBN + 2 * 2 * (kBM * kBK + kBK * kBN),
                    "the wgmma ring must fit the charged allocation");
      err = sm90::launch_wgmma<sm90::kForward, TO>(X, W, O, part, M, N, K, split, smem, st);
    } else {
      static_assert(kStages * stage_bytes<TX, TW>() <=
                        sizeof(float) * kBM * kBN + 2 * stage_bytes<TX, TW>(),
                    "the ring must fit the charged allocation");
      err = set_smem((const void*)mm_reg_kernel<TX, TW, TO>, smem);
      if (err != cudaSuccess) return (int)err;
      mm_reg_kernel<TX, TW, TO><<<grid, kThreads, smem, st>>>(X, W, O, part, M, N, K, split);
      err = cudaGetLastError();
    }
  } else {
    err = set_smem((const void*)mm_simple_kernel<TX, TW, TO>, smem);
    if (err != cudaSuccess) return (int)err;
    mm_simple_kernel<TX, TW, TO><<<grid, kThreads, smem, st>>>(X, W, O, part, M, N, K, bm,
                                                               bn, bk, split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t n4 = (size_t)M * N / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  reduce_slabs_kernel<TO><<<(int)(want < 2048 ? want : 2048), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(part), O, n4, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream` over a grid of (N/bn, M/bm, split); with split > 1
// `part` holds split slabs of M*N floats and a second kernel sums them into
// O in order. `reg` (from matmul.py::template) selects the kernel at the
// planner's tile, which takes only that tile: 1 mm_reg_kernel (f32 and the
// mixed routes), 2 mm_wgmma_kernel (bf16); 0 the simple kernel. Returns
// cudaGetLastError() (0 on success).
int repro_matmul_f32(const float* X, const float* W, float* O, float* part, int M,
                     int N, int K, int bm, int bn, int bk, int split, int reg,
                     void* stream) {
  return launch<float, float, float>(X, W, O, part, M, N, K, bm, bn, bk, split, reg,
                                     stream);
}

// The same for bf16 X, W and O (f32 accumulator and slabs).
int repro_matmul_bf16(const bf16* X, const bf16* W, bf16* O, float* part, int M, int N,
                      int K, int bm, int bn, int bk, int split, int reg, void* stream) {
  return launch<bf16, bf16, bf16>(X, W, O, part, M, N, K, bm, bn, bk, split, reg, stream);
}

// bf16 X against f32 W, writing bf16 O (fc1 on the CNN's bf16 route).
int repro_matmul_bf16xf32_bf16(const bf16* X, const float* W, bf16* O, float* part, int M,
                               int N, int K, int bm, int bn, int bk, int split, int reg,
                               void* stream) {
  return launch<bf16, float, bf16>(X, W, O, part, M, N, K, bm, bn, bk, split, reg, stream);
}

// bf16 X against f32 W, writing f32 O (the im2col patch GEMM on that route).
int repro_matmul_bf16xf32_f32(const bf16* X, const float* W, float* O, float* part, int M,
                              int N, int K, int bm, int bn, int bk, int split, int reg,
                              void* stream) {
  return launch<bf16, float, float>(X, W, O, part, M, N, K, bm, bn, bk, split, reg,
                                    stream);
}

}  // extern "C"
