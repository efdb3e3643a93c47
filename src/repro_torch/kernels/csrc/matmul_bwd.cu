// The FC layer's backward matmuls for the H100 (sm_90a), f32 or bf16
// operands, f32 accumulators and f32 outputs:
//   NT     dX[M,K] = dY[M,N] . W[K,N]^T             (repro_matmul_nt_f32/_bf16)
//   TN     dW[K,N] = X[M,K]^T . dY[M,N]             (repro_matmul_tn_f32/_bf16)
//   fused  both from one read of each dY tile       (repro_matmul_dxdw_f32/_bf16)
//
// Replaces: src/repro/kernels/matmul/bwd.py::_mm_nt_kernel
// (matmul_nt_pallas), ::_mm_tn_kernel (matmul_tn_pallas) and
// ::_mm_dxdw_kernel (matmul_dx_dw_pallas).
//
// What bounds the f32 routes here: at the CNN's FC shapes (fc1 256x2048x4096, fc2
// 256x4096x1000; the fused kernel's at 128 rows) and the transformer's
// (M = 8192 or 2048, K and N from 1024 to 151936) the arithmetic intensity
// is far above the card's f32 balance point (about 20 flop/B), so the
// bound is f32 operations on the CUDA cores (67 TFLOP/s; no tensor cores).
// What keeps a kernel below it is shared-memory traffic per FMA, bank
// conflicts, and grids under one wave.
//
// NT at the planner's tile (bm 64, bk 128, bn 32; every shape of both
// steps), f32 and the mixed route run mm_nt_reg_kernel:
//   * Registers. 256 threads, each a 4 x 8 tile of dX (rows mi*4..+3,
//     columns kj*4..+3 and 64+kj*4..+3) in registers for the block's
//     whole N loop. Per contraction index it reads three float4s from
//     shared memory for 32 FMAs; a warp's reads are four A chunks and two
//     runs of eight B chunks, each within one 128-byte line.
//   * Staging. Both operands have N, the contraction, as their row, so
//     both tiles are transposed on the way in: each thread loads float4s
//     of dY and W rows from device memory (eight threads cover one
//     128-byte run of a row) into registers during the current step's
//     FMAs and writes them contraction-major, gs[bn][bm] and ws[bn][bk],
//     with the column XOR-swizzled by ((n >> 2) & 7) << 2: the 32 scalar
//     stores of a warp land in 32 distinct banks and the float4 reads stay
//     whole. Two shared-memory stages and the register stage keep one step
//     in flight, with one barrier a step.
//   * Epilogue. The [bm][bk] accumulator region the planner charges is
//     free until the end: the register tiles go there and leave as
//     coalesced 16-byte stores.
//   * Small grids. Where the (k, m) grid is under one wave of SMs (fc1 and
//     fc2 dX), the N loop is split over a number of blocks fixed by the
//     shapes (bwd.py::nt_split); each writes a partial f32 slab and a
//     second kernel sums the slabs in order, so the result is the same on
//     every run.
// TN at the planner's tile (bm 32, bk 64, bn 128; every shape of both
// steps), mm_tn_reg_kernel, is the forward matmul's register kernel
// (matmul.cu::mm_reg_kernel) with both operands contraction-major as they
// lie:
//   * Registers. 256 threads, each a 4 x 8 tile of dW (rows mi*4..+3,
//     columns kj*4..+3 and 64+kj*4..+3) in registers for the block's
//     whole M loop; per contraction index three float4 reads for 32 FMAs,
//     a warp's reads four X chunks and two runs of eight dY chunks.
//   * Staging. The X tile [bm][bk] is the forward kernel's transposed
//     xs[bk][bm] and the dY tile [bm][bn] its W tile, so both go in with
//     16-byte cp.async and no transpose: a ring of three stages of both
//     (73,728 B) in the charged 81,920 B, copies two steps ahead, one
//     barrier a step.
//   * Epilogue. The register tiles go to the first bk*bn floats and leave
//     as coalesced 16-byte stores.
//   * Small grids. Where the (n, k) grid is under one wave of SMs (the
//     transformer's wo), the M loop is split over a number of blocks fixed
//     by the shapes (bwd.py::tn_split), summed in order as NT's slabs are.
// The fused kernel at the planner's tile (bm 64, bn 32, bk 128) and an
// M of one to three m-blocks (every batch the fused schedule fits, up to
// 192), mm_dxdw_reg_kernel<NM>: a block owns one k-block and a share of
// the n-blocks; for each n-block it walks the NM m-blocks, and each step
// feeds one dY tile [bm][bn] to both contractions.
//   * Registers. Each thread holds NM 4 x 8 dX tiles (NT's mapping: rows
//     mi*4..+3 of each m-block, columns kj*4.. and 64+kj*4..) for the whole
//     loop, and one 4 x 4 tile of the n-block's dW [bk][bn] (rows ki*4..+3,
//     columns nj*4..+3), zeroed at each n-block and stored with 16-byte
//     stores after its last m-block.  The m loop is unrolled, so every
//     register index is a constant.
//   * Staging. The X strip [M][bk] is the same for every n-block, so it
//     goes in once, by 16-byte cp.async, into the charged whole-M strip
//     region.  Each dY tile is loaded once from device memory (float4s into
//     registers during the current step's FMAs) and written twice: as it
//     lies, gs[bm][bn], for dW (contract M), and transposed and swizzled,
//     gts[bn][bm], for dX (contract N), as NT stages it.  The W tile of an
//     n-block goes through registers into a swizzled ws[bn][bk] during the
//     n-block's last step.  Two stages of each, one barrier a step.
//   * Epilogue. The register dX tiles go through the X strip's region and
//     out as coalesced 16-byte stores.
//   * Small grids. The K/bk grid alone is under one wave of SMs (fc1 16
//     blocks, fc2 32), so the n-blocks are split over a number of blocks
//     fixed by the shapes (bwd.py::dxdw_split): each dW tile still has one
//     owner and is written once; each block writes a partial dX strip to
//     its slab and the slabs are summed in order as NT's are.
// The wrappers pick the register kernels (bwd.py::tn_template for TN,
// bwd.py::dxdw_template for the fused kernel; NT dispatches on its tile
// here).  Other blocks run the simple kernels: 256 threads, a 4 x 8
// register item a step, the f32 accumulator in shared memory, operands
// staged with cp.async two stages deep (the W tile transposed by 4-byte
// copies).
//   * NT, mm_nt_kernel: one block per dX tile [bm][bk]; the N axis is the
//     loop, split as the register kernel's.
//   * TN, mm_tn_kernel: one block per dW tile [bk][bn]; the M axis is the
//     loop, split as the register kernel's.  Each step stages
//     X[m0:m0+bm, k0:k0+bk] and dY[m0:m0+bm, n0:n0+bn] as they lie and
//     contracts over their shared row axis.
//   * fused, mm_dxdw_kernel: one block per k-block and split part.  It
//     loops its n-blocks and, inside them, m-blocks; each step stages one
//     dY tile, the W tile (transposed) and the X tile, and feeds the dY
//     tile to both contractions.  The whole-M dX strip [M][bk] and the dW
//     tile [bk][bn] stay in shared memory: the dW tile flushes after each
//     n-block, the dX strip (or slab) once at the end.
// Shared memory per block is exactly what the planners charge, with the
// operand tiles at e = sizeof(T) bytes an element and the accumulators f32:
//   NT 4*bm*bk + 2*e*(bm*bn + bn*bk), TN 4*bk*bn + 2*e*(bm*bk + bm*bn),
//   fused 2*e*(bm*bn + bk*bn + bm*bk) + 4*(M*bk + bk*bn).
// bf16 NT (repro_matmul_nt_bf16) at the planner's tile: mm_wgmma_kernel
// (gemm_sm90.cuh), on the tensor cores. It replaces _mm_nt_kernel on the
// path repro trains in bf16; its bound is the tensor cores' 989 TFLOP/s
// (every call on the path is far above bf16's 295 flop/B balance point).
// dY is a K-major A tile and W, read as W^T, a K-major B tile (both with the
// 64-byte swizzle: N, the contraction, lies along their rows, which is
// wgmma's own layout) of wgmma m64n128k16, copied by TMA into a four-stage
// ring in the planner's 57,344 B; the f32 dX tile lives in registers, the
// CUDA cores add it into a second register tile every few steps (the
// logits' dX sums 151,936 terms), and it leaves as f32 (or as this split
// part's slab). NT picks it on its tile and bf16 operands (as
// bwd.py::nt_template names it, "wgmma"); nothing else takes bf16 at that
// tile. ptxas (nvcc 12.9): 136 registers, no spills.
// bf16 TN (repro_matmul_tn_bf16) at the planner's tile: the same kernel, on
// the tensor cores. It replaces _mm_tn_kernel on the path repro trains in
// bf16, bound by the tensor cores as NT is. dW = X^T . dY is a 64 x 128 dW
// tile a block over 32 rows of the batch a step: X, read as X^T, is an
// MN-major A tile (one [32][64] TMA box at the 128-byte swizzle, the
// descriptor's transpose bit) and dY an MN-major B tile laid out as the
// forward's W. 57,344 B, the f32 tile in registers with a promotion every 8
// steps (the batch's 8,192 rows are 256 steps), split and summed as the FMA
// kernel's; bwd.py::tn_template names it "wgmma" and passes the choice.
// ptxas (nvcc 12.9): 136 registers, no spills.
// bf16 elsewhere: every kernel is a template on the operand type T. Each
// four-element unit of the f32 kernels (a float4, a 16-byte cp.async) is
// four bf16 of 8 bytes, so every thread mapping, swizzle, tile and loop is
// the f32 kernel's; the operand tiles sit in shared memory as bf16 and are
// converted to f32 (__bfloat162float) as they are read for the FMAs. The
// simple kernels' transposed W tile is staged by plain 2-byte copies
// (cp.async moves 4 bytes at least). The fused register kernel keeps the
// bf16 X strip in the front half of the f32 dX strip's charged room, which
// its epilogue fills. dX and dW come out f32, as repro's FC backward asks
// (out_dtype=f32); the caller casts them. The FMAs of the fused kernel stay
// f32 on the CUDA cores (tensor cores are later work).
// bf16 dY and X against f32 W (repro_matmul_nt_bf16xf32,
// repro_matmul_dxdw_bf16xf32: fc1's backward on the CNN's bf16 route, where
// repro's type promotion keeps the weights f32): NT and the fused kernels
// are templates on the activations' type TA (dY, X) and W's type TW. Each
// operand is read from device memory and staged in its own type, W as its
// f32 kernel stages it and dY and X as their bf16 kernel does, and
// converted to f32 as it leaves shared memory; the accumulators and
// outputs stay f32. Shared memory counts each operand at its own size:
//   NT 4*bm*bk + 2*(sizeof(TA)*bm*bn + sizeof(TW)*bn*bk),
//   fused 2*(sizeof(TA)*(bm*bn + bm*bk) + sizeof(TW)*bk*bn) + 4*(M*bk + bk*bn).
// The fused register kernel of that route is built for two m-blocks (the
// CNN's batch 128) alone: each further instantiation adds seconds to a build
// that the card's first call waits on; other batches take the simple kernel.
// TN takes X and dY, both bf16 on that route: its bf16 kernel serves it.
// Contract (checked by the Python wrappers): M, N, K multiples of the
// blocks; blocks multiples of 8; 16-byte aligned, contiguous row-major
// operands of one type, or the mixed routes above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTM = 4;  // rows of one thread item
constexpr int kTN = 8;  // columns of one thread item: two runs of 4, cols/2 apart

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The operand region of a kernel's shared memory after `f32_floats` floats
// of f32 accumulators.
template <class T>
__device__ __forceinline__ T* after_f32(unsigned char* smem, size_t f32_floats) {
  return reinterpret_cast<T*>(smem + sizeof(float) * f32_floats);
}

// src[r0:r0+rows, c0:c0+cols] of a row-major matrix with row length ld
// -> dst[rows][cols], four elements per copy.
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int ld, int r0,
                                      int c0, int rows, int cols) {
  const int q = cols / 4;
  for (int e = threadIdx.x; e < rows * q; e += kThreads) {
    const int r = e / q, c = (e % q) * 4;
    cp_async_quad(dst + r * cols + c, src + (size_t)(r0 + r) * ld + c0 + c);
  }
}

// W[k0:k0+bk, n0:n0+bn] (row length N) -> dst[bn][bk], transposed.  Eight
// neighbouring threads read one run of eight elements of a W row.
template <class T>
__device__ __forceinline__ void stage_t(T* dst, const T* __restrict__ W, int N, int k0,
                                        int n0, int bk, int bn) {
  for (int e = threadIdx.x; e < bk * bn; e += kThreads) {
    const int c = (e / (8 * bk)) * 8 + e % 8, r = (e / 8) % bk;
    copy1(dst + c * bk + r, W + (size_t)(k0 + r) * N + n0 + c);
  }
}

// acc[rows][ldc] += A . B with A(i, kk) = a[i*a_rs + kk*a_ks] and
// B(kk, j) = b[kk*ldb + j]; rows a multiple of 4, cols of 8.
template <class TA, class TB>
__device__ __forceinline__ void mma_tile(float* acc, int ldc, const TA* a, int a_rs,
                                         int a_ks, const TB* b, int ldb, int rows, int cols,
                                         int depth) {
  const int half = cols / 2, groups = cols / kTN, items = (rows / kTM) * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int mi = it / groups, nj = it % groups;
    const TA* ar = a + mi * kTM * a_rs;
    const TB* bc = b + nj * 4;
    float r[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) r[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
      const float4 b0 = ld4(bc + kk * ldb);
      const float4 b1 = ld4(bc + kk * ldb + half);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = to_f32(ar[i * a_rs + kk * a_ks]);
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

// The contraction steps [t0, t1) of split part blockIdx.z.
__device__ __forceinline__ void split_share(int n_steps, int split, int* t0, int* t1) {
  *t0 = (int)((long long)blockIdx.z * n_steps / split);
  *t1 = (int)((long long)(blockIdx.z + 1) * n_steps / split);
}

template <class TA, class TW>
__global__ void __launch_bounds__(kThreads)
    mm_nt_kernel(const TA* __restrict__ G, const TW* __restrict__ W, float* __restrict__ DX,
                 int M, int N, int K, int bm, int bn, int bk, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);     // [bm][bk]
  TA* gs = after_f32<TA>(smem_raw, (size_t)bm * bk);   // 2 stages of [bm][bn]
  TW* ws = reinterpret_cast<TW*>(gs + 2 * bm * bn);    // 2 stages of [bn][bk] (W^T)
  const int k0 = blockIdx.x * bk, m0 = blockIdx.y * bm;
  int t0, t1;
  split_share(N / bn, split, &t0, &t1);

  zero(acc, bm * bk);
  if (t0 < t1) {
    stage(gs, G, N, m0, t0 * bn, bm, bn);
    stage_t(ws, W, N, k0, t0 * bn, bk, bn);
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
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
  flush(DX + (size_t)blockIdx.z * M * K, K, m0, k0, acc, bm, bk);
}

// NT at the planner's tile: see the header.
constexpr int kNtBM = 64, kNtBN = 32, kNtBK = 128;

__device__ __forceinline__ int nt_swz(int n) { return ((n >> 2) & 7) << 2; }

// Loader rows lr, lr+32, ... (R of them) of a tile, four-element column lc
// (n = lc*4..+3), transposed into dst[n][row ^ nt_swz(n)] (row length ld):
// the 32 scalar stores of a warp land in 32 distinct banks (at f32).
template <int R, class T, class Q>
__device__ __forceinline__ void store_swz(T* dst, int ld, const Q (&v)[R], int lr, int lc) {
  const int sw = lc << 2;  // nt_swz(n) for n = lc*4 + j
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = (lr + 32 * i) ^ sw;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[(lc * 4 + j) * ld + c] = elem(v[i], j);
  }
}

// r += dY tile . W tile^T over one bn step, for the 4 x 8 dX item (rows
// mi*4..+3, cols kj*4.., 64+kj*4..): g the swizzled [bn][bm] dY tile, w the
// swizzled [bn][bk] W tile.
template <class TA, class TW>
__device__ __forceinline__ void nt_tile_fma(float (&r)[4][8], const TA* g, const TW* w,
                                            int mi, int kj) {
#pragma unroll
  for (int kk = 0; kk < kNtBN; ++kk) {
    const int sw = nt_swz(kk);
    const float4 a = ld4(g + kk * kNtBM + ((mi * 4) ^ sw));
    const float4 b0 = ld4(w + kk * kNtBK + ((kj * 4) ^ sw));
    const float4 b1 = ld4(w + kk * kNtBK + 64 + ((kj * 4) ^ sw));
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) r[i][j] = fmaf(av[i], bv[j], r[i][j]);
  }
}

// The 4 x 8 dX item -> rows (mi*4..+3) of acc[..][kNtBK] in shared memory.
__device__ __forceinline__ void nt_item_out(float* acc, const float (&r)[4][8], int mi,
                                            int kj) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = acc + (mi * 4 + i) * kNtBK;
    *reinterpret_cast<float4*>(row + kj * 4) = make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
    *reinterpret_cast<float4*>(row + 64 + kj * 4) =
        make_float4(r[i][4], r[i][5], r[i][6], r[i][7]);
  }
}

// src[rows][kNtBK] -> out[r0:r0+rows, k0:k0+kNtBK] (row length K), 16 bytes
// per store.
__device__ __forceinline__ void nt_rows_out(float* __restrict__ out, int K, int r0, int k0,
                                            const float* src, int rows) {
  for (int e = threadIdx.x; e < rows * kNtBK / 4; e += kThreads) {
    const int row = e / (kNtBK / 4), c4 = e % (kNtBK / 4);
    *reinterpret_cast<float4*>(out + (size_t)(r0 + row) * K + k0 + c4 * 4) =
        *reinterpret_cast<const float4*>(src + row * kNtBK + c4 * 4);
  }
}

template <class TA, class TW>
__global__ void __launch_bounds__(kThreads, 2)
    mm_nt_reg_kernel(const TA* __restrict__ G, const TW* __restrict__ W,
                     float* __restrict__ DX, int M, int N, int K, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc_s = reinterpret_cast<float*>(smem_raw);        // [bm][bk], the epilogue's
  TA* gs = after_f32<TA>(smem_raw, (size_t)kNtBM * kNtBK);  // 2 stages of [bn][bm], swizzled
  TW* ws = reinterpret_cast<TW*>(gs + 2 * kNtBN * kNtBM);   // 2 stages of [bn][bk], swizzled
  const int k0 = blockIdx.x * kNtBK, m0 = blockIdx.y * kNtBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = (warp >> 1) * 4 + (lane >> 3);  // 0..15: rows mi*4..+3
  const int kj = (warp & 1) * 8 + (lane & 7);    // 0..15: cols kj*4.., 64+kj*4..
  int t0, t1;
  split_share(N / kNtBN, split, &t0, &t1);

  // Loader roles: row tid/8 (+32 per round) of a tile, four-element column tid%8.
  const int lr = tid >> 3, lc = tid & 7;
  const TA* gsrc = G + (size_t)(m0 + lr) * N + lc * 4;
  const TW* wsrc = W + (size_t)(k0 + lr) * N + lc * 4;
  quad_t<TA> rg[2];
  quad_t<TW> rw[4];
  auto load = [&](int t) {
    const int n0 = t * kNtBN;
#pragma unroll
    for (int i = 0; i < 2; ++i) rg[i] = ldg4(gsrc + (size_t)i * 32 * N + n0);
#pragma unroll
    for (int i = 0; i < 4; ++i) rw[i] = ldg4(wsrc + (size_t)i * 32 * N + n0);
  };
  auto store = [&](int s) {
    store_swz(gs + s * kNtBN * kNtBM, kNtBM, rg, lr, lc);
    store_swz(ws + s * kNtBN * kNtBK, kNtBK, rw, lr, lc);
  };

  float r[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) r[i][j] = 0.f;

  if (t0 < t1) {
    load(t0);
    store(0);
  }
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) load(t + 1);  // in flight during this step's FMAs
    nt_tile_fma(r, gs + s * kNtBN * kNtBM, ws + s * kNtBN * kNtBK, mi, kj);
    if (t + 1 < t1) store(s ^ 1);
    __syncthreads();
  }

  // Registers -> the accumulator region -> 16-byte stores of the dX tile
  // (or of this part's slab).
  nt_item_out(acc_s, r, mi, kj);
  __syncthreads();
  nt_rows_out(DX + (size_t)blockIdx.z * M * K, K, m0, k0, acc_s, kNtBM);
}

// out[i] = sum over s of part[s][i], s in order, four floats a thread.
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
__global__ void __launch_bounds__(kThreads)
    mm_tn_kernel(const T* __restrict__ X, const T* __restrict__ G, float* __restrict__ DW,
                 int M, int N, int K, int bm, int bn, int bk, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [bk][bn]
  T* xs = after_f32<T>(smem_raw, (size_t)bk * bn);  // 2 stages of [bm][bk]
  T* gs = xs + 2 * bm * bk;                         // 2 stages of [bm][bn]
  const int n0 = blockIdx.x * bn, k0 = blockIdx.y * bk;
  int t0, t1;
  split_share(M / bm, split, &t0, &t1);

  zero(acc, bk * bn);
  if (t0 < t1) {
    stage(xs, X, K, t0 * bm, k0, bm, bk);
    stage(gs, G, N, t0 * bm, n0, bm, bn);
  }
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
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
  flush(DW + (size_t)blockIdx.z * K * N, N, k0, n0, acc, bk, bn);
}

// TN at the planner's tile: see the header.
constexpr int kTnBM = 32, kTnBK = 64, kTnBN = 128, kTnStages = 3;
constexpr int kTnXs = kTnBM * kTnBK, kTnStage = kTnXs + kTnBM * kTnBN;

template <class T>
__global__ void __launch_bounds__(kThreads, 2)
    mm_tn_reg_kernel(const T* __restrict__ X, const T* __restrict__ G,
                     float* __restrict__ DW, int M, int N, int K, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // Stage s: xs[bm][bk] at smem + s*kTnStage, gs[bm][bn] after it.
  const int n0 = blockIdx.x * kTnBN, k0 = blockIdx.y * kTnBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = (warp >> 1) * 4 + (lane >> 3);  // 0..15: dW rows mi*4..+3
  const int kj = (warp & 1) * 8 + (lane & 7);    // 0..15: cols kj*4.., 64+kj*4..
  int t0, t1;
  split_share(M / kTnBM, split, &t0, &t1);
  const int n_t = t1 - t0;

  auto stage_tn = [&](int t, int s) {
    T* xs = smem + s * kTnStage;
    T* gs = xs + kTnXs;
    const size_t m0 = (size_t)t * kTnBM;
#pragma unroll
    for (int i = 0; i < kTnXs / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 4, c4 = e & 15;
      cp_async_quad(xs + r * kTnBK + c4 * 4, X + (m0 + r) * K + k0 + c4 * 4);
    }
#pragma unroll
    for (int i = 0; i < kTnBM * kTnBN / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads, r = e >> 5, c4 = e & 31;
      cp_async_quad(gs + r * kTnBN + c4 * 4, G + (m0 + r) * N + n0 + c4 * 4);
    }
  };

  float r[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) r[i][j] = 0.f;

  if (n_t > 0) stage_tn(t0, 0);
  cp_async_commit();
  if (n_t > 1) stage_tn(t0 + 1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  int s = 0;  // the stage of step i; the ring is kTnStages deep
  for (int i = 0; i < n_t; ++i) {
    const int s1 = s + 1 == kTnStages ? 0 : s + 1, s2 = s1 + 1 == kTnStages ? 0 : s1 + 1;
    if (i + 2 < n_t) stage_tn(t0 + i + 2, s2);
    cp_async_commit();
    const T* xs = smem + s * kTnStage;
    const T* gs = xs + kTnXs;
#pragma unroll
    for (int mm = 0; mm < kTnBM; ++mm) {
      const float4 a = ld4(xs + mm * kTnBK + mi * 4);
      const float4 b0 = ld4(gs + mm * kTnBN + kj * 4);
      const float4 b1 = ld4(gs + mm * kTnBN + 64 + kj * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 8; ++j) r[ii][j] = fmaf(av[ii], bv[j], r[ii][j]);
    }
    cp_async_wait<1>();  // step i+1 has landed; step i+2 may be in flight
    __syncthreads();
    s = s1;
  }
  cp_async_wait<0>();

  // Registers -> the first bk*bn floats -> 16-byte stores of the dW tile
  // (or of this part's slab).
  float* acc = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = acc + (mi * 4 + i) * kTnBN;
    *reinterpret_cast<float4*>(row + kj * 4) = make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
    *reinterpret_cast<float4*>(row + 64 + kj * 4) =
        make_float4(r[i][4], r[i][5], r[i][6], r[i][7]);
  }
  __syncthreads();
  float* out = DW + (size_t)blockIdx.z * K * N;
  for (int e = tid; e < kTnBK * kTnBN / 4; e += kThreads) {
    const int row = e / (kTnBN / 4), c4 = e % (kTnBN / 4);
    *reinterpret_cast<float4*>(out + (size_t)(k0 + row) * N + n0 + c4 * 4) =
        *reinterpret_cast<const float4*>(acc + row * kTnBN + c4 * 4);
  }
}

template <class TA, class TW>
__global__ void __launch_bounds__(kThreads)
    mm_dxdw_kernel(const TA* __restrict__ G, const TW* __restrict__ W,
                   const TA* __restrict__ X, float* __restrict__ DX, float* __restrict__ DW,
                   int M, int N, int K, int bm, int bn, int bk, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dxs = reinterpret_cast<float*>(smem_raw);             // [M][bk] whole-M dX strip
  float* dws = dxs + M * bk;                                   // [bk][bn] dW tile
  TA* gs = after_f32<TA>(smem_raw, (size_t)M * bk + bk * bn);  // 2 stages of [bm][bn]
  TW* ws = reinterpret_cast<TW*>(gs + 2 * bm * bn);            // 2 stages of [bn][bk] (W^T)
  TA* xs = reinterpret_cast<TA*>(ws + 2 * bn * bk);            // 2 stages of [bm][bk]
  const int k0 = blockIdx.x * bk, n_m = M / bm;
  int t0, t1;  // this part's n-blocks; its steps run [t0*n_m, t1*n_m)
  split_share(N / bn, split, &t0, &t1);
  const int first = t0 * n_m, steps = t1 * n_m;

  zero(dxs, M * bk);
  zero(dws, bk * bn);
  if (first < steps) {
    stage(gs, G, N, 0, t0 * bn, bm, bn);
    stage_t(ws, W, N, k0, t0 * bn, bk, bn);
    stage(xs, X, K, 0, k0, bm, bk);
  }
  cp_async_commit();
  for (int t = first; t < steps; ++t) {
    const int s = (t - first) & 1, nb = t / n_m, mb = t % n_m;
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
    const TA* gt = gs + s * bm * bn;
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
  flush(DX + (size_t)blockIdx.z * M * K, K, 0, k0, dxs, M, bk);
}

// r += the X strip's m-block x[bm][bk]^T . the dY tile g[bm][bn] for the
// 4 x 4 dW item (rows ki*4..+3, cols nj*4..+3).
template <class T>
__device__ __forceinline__ void tn_tile_fma(float (&r)[4][4], const T* x, const T* g, int ki,
                                            int nj) {
#pragma unroll
  for (int mm = 0; mm < kNtBM; ++mm) {
    const float4 a = ld4(x + mm * kNtBK + ki * 4);
    const float4 b = ld4(g + mm * kNtBN + nj * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = fmaf(av[i], bv[j], r[i][j]);
  }
}

// The fused kernel at the planner's tile (NT's) with NM m-blocks: see the
// header.
template <int NM, class TA, class TW>
__global__ void __launch_bounds__(kThreads, 1)
    mm_dxdw_reg_kernel(const TA* __restrict__ G, const TW* __restrict__ W,
                       const TA* __restrict__ X, float* __restrict__ DX,
                       float* __restrict__ DW, int N, int K, int split) {
  constexpr int M = NM * kNtBM;
  constexpr int kG = kNtBM * kNtBN, kW = kNtBN * kNtBK;  // elements of a dY, W tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The charged f32 dX strip's room [M][bk]: the X strip (in TA) until the
  // last step, then the dX epilogue (f32).
  TA* xs = reinterpret_cast<TA*>(smem_raw);
  float* dx_out = reinterpret_cast<float*>(smem_raw);
  TA* gts = after_f32<TA>(smem_raw, (size_t)M * kNtBK);  // 2 stages of [bn][bm], swizzled (dX)
  TA* gs = gts + 2 * kG;                                 // 2 stages of [bm][bn] as it lies (dW)
  TW* ws = reinterpret_cast<TW*>(gs + 2 * kG);           // 2 stages of [bn][bk], swizzled
  const int k0 = blockIdx.x * kNtBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = (warp >> 1) * 4 + (lane >> 3);  // dX rows mi*4..+3 of each m-block
  const int kj = (warp & 1) * 8 + (lane & 7);    // dX cols kj*4.., 64+kj*4..
  const int ki = warp * 4 + (lane >> 3);         // dW rows ki*4..+3
  const int nj = lane & 7;                       // dW cols nj*4..+3
  int t0, t1;  // this part's n-blocks
  split_share(N / kNtBN, split, &t0, &t1);

  for (int e = tid; e < M * kNtBK / 4; e += kThreads) {
    const int r = e / (kNtBK / 4), c4 = e % (kNtBK / 4);
    cp_async_quad(xs + r * kNtBK + c4 * 4, X + (size_t)r * K + k0 + c4 * 4);
  }
  cp_async_commit();

  // Loader roles: row tid/8 (+32 per round) of a tile, four-element column tid%8.
  const int lr = tid >> 3, lc = tid & 7;
  const TA* gsrc = G + (size_t)lr * N + lc * 4;
  const TW* wsrc = W + (size_t)(k0 + lr) * N + lc * 4;
  quad_t<TA> rg[2];
  quad_t<TW> rw[4];
  auto load_g = [&](int nb, int mb) {
    const TA* p = gsrc + (size_t)mb * kNtBM * N + nb * kNtBN;
#pragma unroll
    for (int i = 0; i < 2; ++i) rg[i] = ldg4(p + (size_t)i * 32 * N);
  };
  auto load_w = [&](int nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rw[i] = ldg4(wsrc + (size_t)i * 32 * N + nb * kNtBN);
  };
  auto store_g = [&](int s) {  // the dY tile both ways
    store_swz(gts + s * kG, kNtBM, rg, lr, lc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<quad_t<TA>*>(gs + s * kG + (lr + 32 * i) * kNtBN + lc * 4) = rg[i];
  };

  float acc[NM][4][8];
#pragma unroll
  for (int b = 0; b < NM; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[b][i][j] = 0.f;

  if (t0 < t1) {
    load_w(t0);
    load_g(t0, 0);
    store_swz(ws, kNtBK, rw, lr, lc);
    store_g(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int nb = t0; nb < t1; ++nb) {
    const TW* w = ws + ((nb - t0) & 1) * kW;
    float dw[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dw[i][j] = 0.f;
#pragma unroll
    for (int mb = 0; mb < NM; ++mb) {
      const int s = ((nb - t0) * NM + mb) & 1;  // this step's dY stage
      const bool next_w = mb == NM - 1 && nb + 1 < t1;
      const bool next_g = mb < NM - 1 || nb + 1 < t1;
      if (next_g) load_g(mb < NM - 1 ? nb : nb + 1, mb < NM - 1 ? mb + 1 : 0);
      if (next_w) load_w(nb + 1);  // both in flight during this step's FMAs
      nt_tile_fma(acc[mb], gts + s * kG, w, mi, kj);
      tn_tile_fma(dw, xs + mb * kNtBM * kNtBK, gs + s * kG, ki, nj);
      if (next_g) store_g(s ^ 1);
      if (next_w) store_swz(ws + (((nb - t0) & 1) ^ 1) * kW, kNtBK, rw, lr, lc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(DW + (size_t)(k0 + ki * 4 + i) * N + nb * kNtBN + nj * 4) =
          make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
  }

  // Registers -> the X strip's room -> 16-byte stores of the dX strip (or
  // of this part's slab).  The last step's barrier ended every read of the
  // X strip.
#pragma unroll
  for (int b = 0; b < NM; ++b) nt_item_out(dx_out + b * kNtBM * kNtBK, acc[b], mi, kj);
  __syncthreads();
  nt_rows_out(DX + (size_t)blockIdx.z * M * K, K, 0, k0, dx_out, M);
}


cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Sum `split` slabs of n floats in `part` into `out`, in order.
cudaError_t reduce_slabs(const float* part, float* out, size_t n, int split,
                         cudaStream_t st) {
  const size_t n4 = n / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  reduce_slabs_kernel<<<(int)(want < 2048 ? want : 2048), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), n4, split);
  return cudaGetLastError();
}

template <int NM, class TA, class TW>
cudaError_t launch_dxdw_reg(dim3 grid, size_t smem, cudaStream_t st, const TA* G,
                            const TW* W, const TA* X, float* DX, float* DW, int N, int K,
                            int split) {
  cudaError_t err = set_smem((const void*)mm_dxdw_reg_kernel<NM, TA, TW>, smem);
  if (err != cudaSuccess) return err;
  mm_dxdw_reg_kernel<NM, TA, TW><<<grid, kThreads, smem, st>>>(G, W, X, DX, DW, N, K,
                                                                split);
  return cudaGetLastError();
}

// NT: grid (K/bk, M/bm, split); with split > 1 `part` holds split slabs of
// M*K floats and a second kernel sums them into DX in order.
template <class TA, class TW>
int launch_nt(const TA* G, const TW* W, float* DX, float* part, int M, int N, int K,
              int bm, int bn, int bk, int split, void* stream) {
  const size_t smem = sizeof(float) * (size_t)bm * bk +
                      2 * (sizeof(TA) * (size_t)bm * bn + sizeof(TW) * (size_t)bn * bk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / bk, M / bm, split);
  float* dst = split > 1 ? part : DX;
  cudaError_t err;
  if (bm == kNtBM && bn == kNtBN && bk == kNtBK) {
    if constexpr (std::is_same<TA, bf16>::value && std::is_same<TW, bf16>::value) {
      // dX[M, K] = dY[M, N] . (W[K, N] read as [K][N], K-major): the wgmma kernel.
      static_assert(sm90::kBM == kNtBM && sm90::kBN == kNtBK && sm90::kBK == kNtBN &&
                        sm90::kSmemNeeded <= 4 * kNtBM * kNtBK + 2 * 2 * (kNtBM * kNtBN +
                                                                          kNtBN * kNtBK),
                    "the wgmma ring must fit the charged allocation");
      err = sm90::launch_wgmma<sm90::kNT, float>(G, W, DX, part, M, K, N, split, smem, st);
      if (err != cudaSuccess || split == 1) return (int)err;
      return (int)reduce_slabs(part, DX, (size_t)M * K, split, st);
    } else {
      err = set_smem((const void*)mm_nt_reg_kernel<TA, TW>, smem);
      if (err != cudaSuccess) return (int)err;
      mm_nt_reg_kernel<TA, TW><<<grid, kThreads, smem, st>>>(G, W, dst, M, N, K, split);
    }
  } else {
    err = set_smem((const void*)mm_nt_kernel<TA, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    mm_nt_kernel<TA, TW><<<grid, kThreads, smem, st>>>(G, W, dst, M, N, K, bm, bn, bk,
                                                       split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return (int)reduce_slabs(part, DX, (size_t)M * K, split, st);
}

// TN: grid (N/bn, K/bk, split); with split > 1 `part` holds split slabs of
// K*N floats and a second kernel sums them into DW in order.  `tmpl` (from
// bwd.py::tn_template, its TN_TEMPLATES index) selects the kernel: kTnWgmma
// (bf16 at the planner's tile) mm_wgmma_kernel, kTnRegister (f32 there)
// mm_tn_reg_kernel, each taking only its own tile and route, kTnSimple the
// simple kernel.
constexpr int kTnSimple = 0, kTnRegister = 1, kTnWgmma = 2;
template <class T>
int launch_tn(const T* X, const T* G, float* DW, float* part, int M, int N, int K, int bm,
              int bn, int bk, int split, int tmpl, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const size_t smem = sizeof(float) * (size_t)bk * bn +
                      2 * sizeof(T) * ((size_t)bm * bk + (size_t)bm * bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / bn, K / bk, split);
  float* dst = split > 1 ? part : DW;
  cudaError_t err;
  if (tmpl != kTnSimple) {
    if (bm != kTnBM || bn != kTnBN || bk != kTnBK ||
        tmpl != (kBf16 ? kTnWgmma : kTnRegister))
      return (int)cudaErrorInvalidValue;
    if constexpr (kBf16) {
      // dW[K, N] = (X[M, K] read as X^T: MN-major) . dY[M, N] (MN-major, as the
      // forward's W): the wgmma kernel with the contraction M.
      static_assert(sm90::kBM == kTnBK && sm90::kBN == kTnBN && sm90::kBK == kTnBM &&
                        sm90::kSmemNeeded <= 4 * kTnBK * kTnBN + 2 * 2 * (kTnBM * kTnBK +
                                                                          kTnBM * kTnBN),
                    "the wgmma ring must fit the charged allocation");
      err = sm90::launch_wgmma<sm90::kTN, float>(X, G, DW, part, K, N, M, split, smem, st);
      if (err != cudaSuccess || split == 1) return (int)err;
      return (int)reduce_slabs(part, DW, (size_t)K * N, split, st);
    } else {
      static_assert(kTnStages * kTnStage * sizeof(T) <=
                        sizeof(float) * kTnBK * kTnBN + 2 * kTnStage * sizeof(T),
                    "the ring must fit the charged allocation");
      err = set_smem((const void*)mm_tn_reg_kernel<T>, smem);
      if (err != cudaSuccess) return (int)err;
      mm_tn_reg_kernel<T><<<grid, kThreads, smem, st>>>(X, G, dst, M, N, K, split);
    }
  } else {
    err = set_smem((const void*)mm_tn_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    mm_tn_kernel<T><<<grid, kThreads, smem, st>>>(X, G, dst, M, N, K, bm, bn, bk, split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return (int)reduce_slabs(part, DW, (size_t)K * N, split, st);
}

// fused: grid (K/bk, 1, split); each part owns its n-blocks' dW tiles and,
// with split > 1, writes a partial dX strip to its slab of `part` (split
// slabs of M*K floats), which a second kernel sums into DX in order.
// `reg` (from bwd.py::dxdw_template) selects mm_dxdw_reg_kernel, which
// takes only its own tile and one to three m-blocks, 0 the simple kernel.
template <class TA, class TW>
int launch_dxdw(const TA* G, const TW* W, const TA* X, float* DX, float* DW, float* part,
                int M, int N, int K, int bm, int bn, int bk, int split, int reg,
                void* stream) {
  const size_t smem =
      2 * (sizeof(TA) * ((size_t)bm * bn + (size_t)bm * bk) + sizeof(TW) * (size_t)bk * bn) +
      sizeof(float) * ((size_t)M * bk + (size_t)bk * bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / bk, 1, split);
  float* dst = split > 1 ? part : DX;
  cudaError_t err;
  if (reg) {
    if (bm != kNtBM || bn != kNtBN || bk != kNtBK || M % kNtBM) return (int)cudaErrorInvalidValue;
    static_assert(4 * kNtBM * kNtBN * sizeof(TA) + 2 * kNtBN * kNtBK * sizeof(TW) <=
                      2 * (sizeof(TA) * (kNtBM * kNtBN + kNtBM * kNtBK) +
                           sizeof(TW) * kNtBK * kNtBN) +
                          sizeof(float) * kNtBK * kNtBN,
                  "the dY and W stages must fit the charged allocation beside the X strip");
    const int nm = M / kNtBM;
    if (nm == 2) {
      err = launch_dxdw_reg<2, TA, TW>(grid, smem, st, G, W, X, dst, DW, N, K, split);
    } else if constexpr (std::is_same<TA, TW>::value) {
      if (nm == 1)
        err = launch_dxdw_reg<1, TA, TW>(grid, smem, st, G, W, X, dst, DW, N, K, split);
      else if (nm == 3)
        err = launch_dxdw_reg<3, TA, TW>(grid, smem, st, G, W, X, dst, DW, N, K, split);
      else
        return (int)cudaErrorInvalidValue;
    } else {
      // The mixed route's register kernel is built for two m-blocks alone
      // (the CNN's fc1 at batch 128; bwd.py::dxdw_template): build time.
      return (int)cudaErrorInvalidValue;
    }
  } else {
    err = set_smem((const void*)mm_dxdw_kernel<TA, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    mm_dxdw_kernel<TA, TW><<<grid, kThreads, smem, st>>>(G, W, X, dst, DW, M, N, K, bm, bn,
                                                         bk, split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  return (int)reduce_slabs(part, DX, (size_t)M * K, split, st);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 on success); the _bf16 ones take bf16 operands and write f32 outputs.

int repro_matmul_nt_f32(const float* G, const float* W, float* DX, float* part, int M,
                        int N, int K, int bm, int bn, int bk, int split, void* stream) {
  return launch_nt<float, float>(G, W, DX, part, M, N, K, bm, bn, bk, split, stream);
}
int repro_matmul_nt_bf16(const bf16* G, const bf16* W, float* DX, float* part, int M,
                         int N, int K, int bm, int bn, int bk, int split, void* stream) {
  return launch_nt<bf16, bf16>(G, W, DX, part, M, N, K, bm, bn, bk, split, stream);
}
// bf16 dY against f32 W.
int repro_matmul_nt_bf16xf32(const bf16* G, const float* W, float* DX, float* part, int M,
                             int N, int K, int bm, int bn, int bk, int split,
                             void* stream) {
  return launch_nt<bf16, float>(G, W, DX, part, M, N, K, bm, bn, bk, split, stream);
}

int repro_matmul_tn_f32(const float* X, const float* G, float* DW, float* part, int M,
                        int N, int K, int bm, int bn, int bk, int split, int tmpl,
                        void* stream) {
  return launch_tn<float>(X, G, DW, part, M, N, K, bm, bn, bk, split, tmpl, stream);
}
int repro_matmul_tn_bf16(const bf16* X, const bf16* G, float* DW, float* part, int M,
                         int N, int K, int bm, int bn, int bk, int split, int tmpl,
                         void* stream) {
  return launch_tn<bf16>(X, G, DW, part, M, N, K, bm, bn, bk, split, tmpl, stream);
}

int repro_matmul_dxdw_f32(const float* G, const float* W, const float* X, float* DX,
                          float* DW, float* part, int M, int N, int K, int bm, int bn,
                          int bk, int split, int reg, void* stream) {
  return launch_dxdw<float, float>(G, W, X, DX, DW, part, M, N, K, bm, bn, bk, split, reg,
                                   stream);
}
int repro_matmul_dxdw_bf16(const bf16* G, const bf16* W, const bf16* X, float* DX,
                           float* DW, float* part, int M, int N, int K, int bm, int bn,
                           int bk, int split, int reg, void* stream) {
  return launch_dxdw<bf16, bf16>(G, W, X, DX, DW, part, M, N, K, bm, bn, bk, split, reg,
                                 stream);
}
// bf16 dY and X against f32 W.
int repro_matmul_dxdw_bf16xf32(const bf16* G, const float* W, const bf16* X, float* DX,
                               float* DW, float* part, int M, int N, int K, int bm, int bn,
                               int bk, int split, int reg, void* stream) {
  return launch_dxdw<bf16, float>(G, W, X, DX, DW, part, M, N, K, bm, bn, bk, split, reg,
                                  stream);
}

}  // extern "C"
