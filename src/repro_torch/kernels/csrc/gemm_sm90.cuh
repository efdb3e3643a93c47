// The bf16 x bf16 GEMM on Hopper's tensor cores (sm_90a), shared by the
// forward matmul (matmul.cu, repro_matmul_bf16), NT and TN (matmul_bwd.cu,
// repro_matmul_nt_bf16 / repro_matmul_tn_bf16) at the tiles the H100
// planner picks for them:
//
//   C[M, Nc] = A . B,  a 64 x 128 tile of C a block, 32 of Kc a step,
//
// B either [Kc][Nc] row-major (the forward's W, TN's dY: Nc contiguous,
// "MN-major") or [Nc][Kc] row-major (NT's W read as W^T: Kc contiguous,
// "K-major"); A either [M][Kc] row-major (X of the forward, dY of NT:
// K-major) or [Kc][M] row-major (TN's X read as X^T: MN-major); C f32 or
// bf16. bf16 operands, f32 sums, as repro's _mm_kernel, _mm_nt_kernel and
// _mm_tn_kernel take them (preferred_element_type=f32). The wgmma wrappers
// below also serve flash attention's bf16 kernel (flash_attention.cu).
//
// What bounds it: every call on the path is far above bf16's balance point
// on an H100 (989 TFLOP/s over 3.35 TB/s, about 295 flop/B), so the bound is
// the tensor cores. The design feeds them as follows:
//   * Tensor cores. wgmma.mma_async m64n128k16 (f32 += bf16 . bf16), both
//     operands read from shared memory through descriptors, two a step. One
//     warpgroup (the block's 128 threads) holds the 64 x 128 f32 tile in
//     registers, 64 a thread.
//   * Copies. TMA (cp.async.bulk.tensor.2d) into a ring of kStages stages,
//     one mbarrier a stage, thread 0 issuing: a K-major A tile [64][32] (64
//     B a row) with the 64-byte swizzle, or an MN-major one as one [32][64]
//     box (128 B a row) with the 128-byte swizzle, read through the
//     descriptor's transpose bit; B either as two [32][64] halves with the
//     128-byte swizzle, MN-major as that A, or as one [128][32] tile with the
//     64-byte swizzle, K-major like A. The tensor maps are encoded on the
//     host (cuTensorMapEncodeTiled, looked up through the CUDA runtime, so
//     nothing links libcuda) for each launch's pointers.
//   * Overlap. A step's two wgmmas are one commit group; waiting for all but
//     the newest group frees the stage of the step before, which thread 0
//     refills kStages steps ahead while this step's products run.
//   * Accumulation. The tensor cores' own f32 sum drifts over a long
//     contraction: summed whole inside them, the logits' dX (151,936 terms,
//     9,496 wgmma steps) lay 1.09e-2 from plain on an H100, 4.1 times
//     chip_smoke.py's gate (scripts/wgmma_probe.py promote-none). So every
//     kPromote steps the CUDA cores add the tensor cores' tile into a second
//     f32 register tile (rounded to nearest) and the next wgmma starts its
//     tile anew (scale-d 0): 7.8e-5 there, 0.03 of the gate. TN's dW sums
//     the batch's 8,192 rows (256 steps) the same way.
//   * Order. The forward walks M fastest, so that the blocks in flight share
//     each W column strip (the logits' forward 3.6 -> 1.7 ms on an H100); NT
//     walks its output columns fastest (scripts/wgmma_probe.py
//     order-swapped); TN as kRowsFastest says (tn-order-swapped).
//   * Shared memory. The block allocates exactly the planner's H100 term
//     (57,344 B at bf16, each GEMM's): the ring of four 12,288 B stages (each
//     tile at a 1024-byte boundary, as the swizzles want) and the barriers.
//     The f32 tile the planner charges lives in registers. The epilogue
//     stages the output tile in the ring (rows padded against bank
//     conflicts) and writes it with coalesced 16-byte stores, rounded once
//     to C's type, or as f32 to this split part's slab (the caller sums the
//     slabs in order).
// Deterministic: a fixed order of wgmmas, promotions and slabs.
// ptxas (nvcc 12.9, sm_90a): 136 registers, no spills, for the forward's,
// NT's and TN's instantiations.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                // one warpgroup
constexpr int kBM = 64, kBN = 128, kBK = 32;  // C rows, C columns, contraction a step
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;          // 4,096 B
constexpr int kBTile = kBK * kBN * 2;          // 8,192 B (two 4,096 B halves MN-major)
constexpr int kStageBytes = kBTile + kATile;   // B at the stage's start, then A
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kAlign = 1024;                   // the swizzle patterns' repeat
constexpr int kSmemNeeded = kAlign + kRingBytes + 8 * kStages;
constexpr int kPromote = 8;                    // wgmma steps between promotions
constexpr int kPitch = kBN + 8;                // staged output row, in elements

// The GEMMs that run mm_wgmma_kernel: their operands' layouts (above) and
// whether the grid walks C's rows (blockIdx.x) or its columns fastest.
enum Form { kForward = 0, kNT = 1, kTN = 2 };
constexpr bool kRowsFastest[3] = {true, false, true};  // forward, NT, TN

// -- host: tensor maps ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The row-major bf16 matrix [rows][cols] at `base`, copied in boxes of
// [box_rows][box_cols] with swizzle `swz`.
inline cudaError_t tensor_map(CUtensorMap* map, const bf16* base, int rows, int cols,
                              int box_rows, int box_cols, CUtensorMapSwizzle swz) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<bf16*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -- device: barriers, copies, wgmma ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. The loop stays inside
// one asm block (its labels are local to the braces).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box of `map` at element (c0 along the contiguous axis, c1 along rows)
// into shared memory at `dst`, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle (1: 128-byte, 2: 64-byte).
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2;
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a register tile across
// the asynchronous wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands d[0..N/2) of an m64nNk16 wgmma.
#define SM90_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D16(i) SM90_D8(i), SM90_D8(i + 8)
#define SM90_D32(i) SM90_D16(i), SM90_D16(i + 16)
#define SM90_D64(i) SM90_D32(i), SM90_D32(i + 32)

// d (+)= A . B for one m64nNk16 step into the f32 tile d[0..N/2) (the wgmma
// layout: warp w holds rows w*16.., a thread rows lane/4 and lane/4 + 8,
// columns j*8 + (lane%4)*2 and +1 for j < N/8); `acc` 0 overwrites d.
// ss: A and B from shared memory through descriptors, kTransA / kTransB 1
// where that operand is MN-major. rs: A from registers (four b32 of bf16
// pairs, the fragment of rows lane/4 and lane/4 + 8, columns (lane%4)*2 and
// +8), B from shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : SM90_D8(0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTransA), "n"(kTransB));
  }
};

template <>
struct Wgmma<32> {
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_D16(0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  }
};

template <>
struct Wgmma<64> {
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : SM90_D32(0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  }
};

template <>
struct Wgmma<128> {
  template <int kTransA, int kTransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : SM90_D64(0)
        : "l"(da), "l"(db), "r"(acc), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(kTransB));
  }
};

#undef SM90_D64
#undef SM90_D32
#undef SM90_D16
#undef SM90_D8

__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The f32 tile (the wgmma layout: warp w holds rows w*16.., a thread rows
// lane/4 and lane/4 + 8, columns j*8 + (lane%4)*2 and +1 for j < 16) ->
// `stage` [kBM][kPitch] in T -> dst[m0.., n0..] (row length ld), 16 bytes
// a store.
template <class T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, int ld, int m0, int n0,
                                           const float (&c)[64], unsigned char* stage_raw) {
  T* stage = reinterpret_cast<T*>(stage_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    put2(stage + r * kPitch + j * 8 + col, c[4 * j], c[4 * j + 1]);
    put2(stage + (r + 8) * kPitch + j * 8 + col, c[4 * j + 2], c[4 * j + 3]);
  }
  __syncthreads();
  constexpr int kPer = 16 / sizeof(T), kChunks = kBN / kPer;  // 16-byte chunks a row
#pragma unroll 4
  for (int e = threadIdx.x; e < kBM * kChunks; e += kThreads) {
    const int row = e / kChunks, q = e % kChunks;
    store16(dst + (size_t)(m0 + row) * ld + n0 + q * kPer, stage + row * kPitch + q * kPer);
  }
}

// C (or this split part's f32 slab of P) = A . B over the contraction
// steps [t0, t1) of part blockIdx.z; the grid is (M/kBM, Nc/kBN, split)
// where kRowsFastest[kForm], else (Nc/kBN, M/kBM, split).
template <int kForm, class TC>
__global__ void __launch_bounds__(kThreads)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, TC* __restrict__ C,
                    float* __restrict__ P, int M, int Nc, int Kc, int split) {
  constexpr bool kAMNMajor = kForm == kTN, kBKMajor = kForm == kNT;
  constexpr bool kRows = kRowsFastest[kForm];
  extern __shared__ __align__(kAlign) unsigned char sm90_smem[];
  const uint32_t raw = smem_addr(sm90_smem);
  const uint32_t pad = (kAlign - (raw & (kAlign - 1))) & (kAlign - 1);
  unsigned char* ring = sm90_smem + pad;
  const CUtensorMap *pa = &map_a, *pb = &map_b;
  const uint32_t ring_at = raw + pad, bars = ring_at + kRingBytes;
  const int tid = threadIdx.x;
  // The grid's order: see "Order" above.
  const int m0 = (kRows ? blockIdx.x : blockIdx.y) * kBM;
  const int n0 = (kRows ? blockIdx.y : blockIdx.x) * kBN;
  const int n_steps = Kc / kBK;
  const int t0 = (int)((long long)blockIdx.z * n_steps / split);
  const int n_t = (int)((long long)(blockIdx.z + 1) * n_steps / split) - t0;

  // Thread 0: step i's A and B tiles into stage i % kStages.
  auto issue = [&](int i) {
    const int s = i % kStages, k = (t0 + i) * kBK;
    const uint32_t at = ring_at + s * kStageBytes, bar = bars + 8 * s;
    mbar_expect_tx(bar, kStageBytes);
    if (kBKMajor) {
      tma_load(at, pb, bar, k, n0);
    } else {
      tma_load(at, pb, bar, n0, k);
      tma_load(at + kBTile / 2, pb, bar, n0 + kBN / 2, k);
    }
    if (kAMNMajor)
      tma_load(at + kBTile, pa, bar, m0, k);
    else
      tma_load(at + kBTile, pa, bar, k, m0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages && i < n_t; ++i) issue(i);

  // The tensor cores sum kPromote steps at a time into acc; the CUDA cores
  // add each such sum into `sum`. acc is read only after wgmma_wait<0>, so
  // no wgmma is in flight when it is.
  float acc[64], sum[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = sum[j] = 0.f;
  for (int i0 = 0; i0 < n_t; i0 += kPromote) {
    const int i1 = min(n_t, i0 + kPromote);
    for (int i = i0; i < i1; ++i) {
      const int s = i % kStages;
      mbar_wait(bars + 8 * s, (i / kStages) & 1);
      const uint32_t b = ring_at + s * kStageBytes, a = b + kBTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A K-major: 8-row groups 512 B apart, 16 of the contraction 32 B
        // along a row; MN-major: one 64-column box, 8-row groups of the
        // contraction 1024 B apart.
        const uint64_t da = kAMNMajor ? descriptor(a + kk * 2048, kATile, 1024, kSwizzle128)
                                      : descriptor(a + kk * 32, 16, 512, kSwizzle64);
        // B K-major as A; MN-major: 64-column halves 4096 B apart, 8-row
        // groups of the contraction 1024 B apart.
        const uint64_t db = kBKMajor
                                ? descriptor(b + kk * 32, 16, 512, kSwizzle64)
                                : descriptor(b + kk * 2048, kBTile / 2, 1024, kSwizzle128);
        Wgmma<kBN>::ss<kAMNMajor ? 1 : 0, kBKMajor ? 0 : 1>(acc, da, db, kk > 0 || i > i0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      // Step i-1's products are done in every warp: its stage takes step
      // i-1+kStages.
      __syncthreads();
      if (tid == 0 && i >= 1 && i - 1 + kStages < n_t) issue(i - 1 + kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];
  }

  if (split > 1)
    store_tile(P + (size_t)blockIdx.z * M * Nc, Nc, m0, n0, sum, ring);
  else
    store_tile(C, Nc, m0, n0, sum, ring);
}

// C[M, Nc] (or `split` f32 slabs of it in `part`) = A . B, the operands laid
// out as kForm's (above): A [M][Kc] or (TN) [Kc][M], B [Nc][Kc] (NT) or
// [Kc][Nc]; `smem` is the planner's bytes.
template <int kForm, class TC>
cudaError_t launch_wgmma(const bf16* A, const bf16* B, TC* C, float* part, int M, int Nc,
                         int Kc, int split, size_t smem, cudaStream_t st) {
  constexpr bool kRows = kRowsFastest[kForm];
  if (M % kBM || Nc % kBN || Kc % kBK || smem < (size_t)kSmemNeeded ||
      (kRows ? Nc / kBN : M / kBM) > 65535)
    return cudaErrorInvalidValue;
  constexpr CUtensorMapSwizzle k64 = CU_TENSOR_MAP_SWIZZLE_64B;
  constexpr CUtensorMapSwizzle k128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_a, map_b;
  cudaError_t err = kForm == kTN ? tensor_map(&map_a, A, Kc, M, kBK, kBM, k128)
                                 : tensor_map(&map_a, A, M, Kc, kBM, kBK, k64);
  if (err == cudaSuccess)
    err = kForm == kNT ? tensor_map(&map_b, B, Nc, Kc, kBN, kBK, k64)
                       : tensor_map(&map_b, B, Kc, Nc, kBK, kBN / 2, k128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute((const void*)mm_wgmma_kernel<kForm, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kRows ? dim3(M / kBM, Nc / kBN, split) : dim3(Nc / kBN, M / kBM, split);
  mm_wgmma_kernel<kForm, TC><<<grid, kThreads, smem, st>>>(map_a, map_b, C, part, M, Nc, Kc,
                                                            split);
  return cudaGetLastError();
}

}  // namespace sm90
