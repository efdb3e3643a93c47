// Flash-attention forward for the H100 (sm_90a), f32 or bf16 q/k/v, f32
// scores, softmax and accumulator, the output in q's type: causal and
// sliding-window masks, GQA, padding masks, online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_fa_kernel
// (flash_attention_pallas), the attention cell of the planned transformer
// training step.
//
// What bounds it here: at the main path's shape ([B*Hq, S, D] = [64, 2048,
// 64], causal) each K/V tile is reused by a whole q block, so the kernel
// does about 4*S/2*D = 262k flop per 2*D*4 B of K/V it streams; the bound
// is f32 operations (67 TFLOP/s on the CUDA cores), not the 3.35 TB/s of
// device memory.  It issues plain FMAs (no tensor cores, no TF32: the gates
// are f32 at 1e-4).  The planner's budget leaves one 8-warp block an SM, so
// what keeps it below 67 TFLOP/s is shared-memory traffic per FMA and
// barriers that stall all eight warps.
//
// Query positions: row r of q sits at position q_off + r (a rank's slice of
// a sequence-parallel query sequence; 0 for a whole one), key j at j.  The
// causal and window tile bounds, the whole-tile test and the element masks
// all read q_off + row, so an offset that is not a multiple of the q block
// skips exactly the tiles its masks empty; at q_off = 0 every bound and
// every masked score is the one the kernel had without the offset.
//
// Grid and loop: one thread block per (b*Hq + h, q block) — the Pallas
// kernel's two parallel grid axes.  Its sequential kv grid axis becomes a
// loop inside the block over exactly the KV blocks that the kernel's `run`
// predicate admits (AttentionPlanner.kv_blocks_run): blocks wholly in the
// causal future or wholly before the window are never fetched.  q blocks
// run heaviest first (the last causal block sees the most keys).
//
// Shared memory (dynamic, all of it; == AttentionPlanner._vmem_bytes on the
// H100 machine):
//   Q   [bq][D]          the q block, loaded once;
//   K,V [2][bkv][D] each two stages filled by cp.async, the next KV block's
//                        copy overlapping this block's FMAs;
//   P   2*bq*D floats    each warp's probability rows, [bq/8][PS] a warp with
//                        PS = min(BKV, 2*D) — the planner's second q stage
//                        and f32 accumulator terms, since the accumulator
//                        itself is in registers;
//   m,l [2][bq]          charged by the planner; each row's (m, l) stays in
//                        registers.
// K and V rows keep their 16-byte chunks XOR-swizzled by (row & 7), Q rows
// by (row % RG).
//
// Warps own rows.  Warp w owns rows w*bq/8.. of the q block; its lanes are
// RG row groups g x CL = 32/RG column lanes cl.  A lane holds rows
// g + RG*i of the warp's rows, score columns cl + CL*j of the KV block and
// output chunks cl + CL*h (float4) of D.  A warp's 16-byte shared load
// delivers 512 bytes, four cycles of the 128 bytes a cycle an SM's shared
// memory serves, in which the SM issues 16 warp FMAs; so what sets the
// speed is FMAs per load: 4*RI*CJ per RI + CJ loads in S, 16*RI*OC per
// RI + 4*OC loads per 4 kv rows in P.V, at a register count that leaves
// the compiler room to run loads ahead.  RG is the fastest of 1, 2 and 4
// timed on the H100: at f32 4 at D = 32 and 64, 2 at D = 128, 1 at D = 256
// (bf16 below).
//   * S = Q K^T: per 16-byte chunk of D, RI Q reads (quarters uniform, row
//     groups on distinct bank quads) and CJ K reads (rows cl + CL*j at
//     chunk c ^ (cl & 7): a quarter's eight rows on eight bank quads).
//   * Row max and row sum reduce over the CL column lanes (xor shuffles), so
//     every lane of a row group ends with its rows' (m, l).
//   * P goes to the warp's own slice, its columns XOR-swizzled by g*CL so a
//     store of the warp hits 32 banks, and comes back as float4 (4 kv
//     columns of one row) for P.V after a __syncwarp only.  Where bkv > PS
//     (D = 32 at 128/128) P goes through the slice in column chunks of PS.
//   * P.V, 8 kv rows a step: 2*RI P reads and 8*OC V reads (eight chunks a
//     quarter), from per-lane offsets fixed for the whole kernel.
// So the block needs one barrier per KV block, for the K/V double buffer.
// The softmax works in base 2: log2(e) is folded into the scale on the
// host and ex2.approx replaces expf; a KV block that no mask reaches skips
// the masks.  Masked scores are -inf and the running max starts at -1e30,
// so a masked entry's probability is exactly 0 and a row with no visible
// key keeps l == 0 and is written as 0.
//
// Instantiations, at the planner's H100 blocks: D = 32 at 128/128 (115,712
// B), 64 at 128/128 (230,400 B), 128 at 64/64 (229,888 B), 256 at 32/32
// (229,632 B); each twice, for exactly those blocks (FULL: every bound a
// constant) and for any smaller multiples of 8.
//
// bf16 (repro_flash_attention_bf16): the kernel is a template on the
// operand type T. Every 16-byte chunk above (four floats) is four bf16 of
// 8 bytes, so every lane layout, swizzle (in chunks) and loop is the f32
// kernel's; Q, K and V sit in shared memory as bf16 and are converted to
// f32 (__bfloat162float) as they are read, P stays f32, and the output is
// rounded once (__float2bfloat16_rn). Shared memory is the planner's H100
// term at two bytes an element, 2*2*(bq*D + 2*bkv*D) + 4*bq*D + 8*bq: the
// P slices take PS = min(BKV, D) columns a row in the 6*bq*D bytes left
// after Q, K and V. At two bytes an element the planner's blocks are D = 32
// at 128/128 (66,560 B), 64 at 128/128 (132,096 B), 128 at 128/64
// (197,632 B) and 256 at 64/32 (197,120 B); the wgmma kernel below takes
// those, so the bf16 FMA kernel is built for smaller blocks alone (FULL is
// f32's). RG is the fastest admitted count timed on the H100
// (scripts/flash_rg.py): 4 at D = 32 and 64 (the only one at 32), 2 at
// D = 128 and 256.
//
// bf16 on the tensor cores (fa_wgmma_kernel; flash_attention.py::
// flash_template names it "wgmma" and passes the choice): at block_q 64 or
// 128 and block_kv a multiple of 16 up to the planner's bf16 maxima, the
// FMA kernel above serving every other bf16 block. It computes
// _fa_kernel's function, whose scores, P and accumulator are f32, on
// wgmma. What bounds it: at the main path's shape the tensor cores (bf16's
// balance point is about 295 flop/B; a causal 2048 at D = 64 does about
// 2*S*D = 262k flop per 4*D bytes of K/V it streams a q block).
//   * Warpgroups. One warpgroup (128 threads) per 64 query rows: two at
//     block_q 128, one at 64. Thread 0 issues TMA: Q once, and K and V into
//     two stages, one mbarrier a stage (and one for Q); the tensor maps run
//     over [BH*S, D]. Tiles are laid out for wgmma: D = 32 as 64-byte rows
//     at the 64-byte swizzle, D >= 64 as 64-column panels of 128-byte rows at
//     the 128-byte swizzle (TcTile).
//   * S = Q K^T: wgmma m64n{block_kv}k16, Q (A) and K (B) both K-major from
//     shared memory, D/16 steps, f32 in registers (at a block_kv below the
//     instantiation's, in 16-key chunks of m64n16k16).
//   * Masks and the online softmax on the S fragment: a thread holds rows
//     lane/4 and lane/4 + 8 of its warp's 16; row max and row sum take two
//     xor shuffles over the row's four lanes. Base 2, masked scores -inf,
//     the running max from -1e30, l from the f32 P, as the FMA kernel.
//   * O += P V: P is wgmma's A operand from registers (the S fragment's
//     layout is the A fragment's once packed into bf16 pairs), V (B) is
//     MN-major through the transpose bit (D contiguous, the keys down the
//     rows, as the forward matmul's W). repro multiplies an f32 P, so P goes
//     in as two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), two
//     wgmmas into the same O (kPTerms; scripts/wgmma_probe.py p-one-term
//     times one).
//   * Promotion. The CUDA cores rescale O by alpha once a KV block: at most
//     block_kv/16 <= 8 wgmma steps (each two terms) between them, as the
//     GEMMs' kPromote.
//   * Output. O / l rounded once to bf16, staged in shared memory (rows
//     padded) and written with 16-byte stores; a row with no visible key
//     keeps l == 0 and is written as 0.
//   * Shared memory. The block allocates exactly the planner's bf16 term,
//     smem_bytes(bq, bkv, D, 2): Q, two stages of K and V, the barriers and
//     a 1024-byte alignment; the P and f32 accumulator room it charges stays
//     unused, both living in registers.
//   * Instantiations: D = 32 and 64 at BKV 128, 128 at 64, 256 at 32, each
//     for block_kv == BKV and for smaller ones (FULL). ptxas (nvcc 12.9,
//     sm_90a), FULL / not: 195 / 196, 206 / 219, 168 / 168 and 186 / 192
//     registers, no spills.
//
// Contract (checked by the Python wrapper): D in {32, 64, 128, 256}; bq,
// bkv multiples of 8 up to the instantiation's maxima (the wgmma kernel:
// bq of 64 or 128, bkv of 16, up to the bf16 maxima);
// sequences padded to the blocks; q [BHq, Sq, D], k/v [BHkv, Skv, D] of one
// type, contiguous and 16-byte aligned; BHkv divides BHq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

// Four consecutive elements: a float4, or four bf16 in 8 bytes.
struct __align__(8) bf16x4 {
  bf16 v[4];
};

__device__ __forceinline__ void cp_async_quad(float* dst, const float* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_quad(bf16* dst, const bf16* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 2^x, flushing results below the normal range to 0 (and -inf to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows x D elements from contiguous global rows into a [rows][D] tile whose
// row r keeps its four-element chunk c at c ^ (r % SW).
template <class T, int D, int SW>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int rows) {
  constexpr int nq = D / 4;
  for (int e = threadIdx.x; e < rows * nq; e += kThreads) {
    const int r = e / nq, c = e % nq;
    cp_async_quad(dst + r * D + ((c ^ (r & (SW - 1))) << 2), src + (size_t)r * D + c * 4);
  }
}

// Four elements at byte offset `off` of shared memory, as floats.
template <class T>
__device__ __forceinline__ float4 lds4(const char* base, unsigned off);
template <>
__device__ __forceinline__ float4 lds4<float>(const char* base, unsigned off) {
  return *reinterpret_cast<const float4*>(base + off);
}
template <>
__device__ __forceinline__ float4 lds4<bf16>(const char* base, unsigned off) {
  const bf16x4 q = *reinterpret_cast<const bf16x4*>(base + off);
  return make_float4(__bfloat162float(q.v[0]), __bfloat162float(q.v[1]),
                     __bfloat162float(q.v[2]), __bfloat162float(q.v[3]));
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

// FULL: the launch's blocks are the instantiation's (bq == BQ, bkv == BKV,
// the planner's pick), so every bound below is a constant and every shared
// address a per-lane base plus an immediate; otherwise a lane's rows past
// the warp's and score columns past bkv read a valid row and are masked.
template <class T, int D, int BQ, int BKV, int RG, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                  const T* __restrict__ V, T* __restrict__ O, int group,
                  int sq, int skv, int bq_arg, int bkv_arg, int q_len, int kv_len,
                  int causal, int window, int q_off, float scale_log2) {
  constexpr unsigned E = sizeof(T);             // bytes of an operand element
  constexpr unsigned CB = 4 * E;                // bytes of a four-element chunk
  constexpr int CL = 32 / RG;                   // column lanes of a row group
  constexpr int RI = BQ / 8 / RG;               // rows a lane holds
  constexpr int CJ = BKV / CL;                  // score columns a lane holds
  constexpr int PW = E == 4 ? 2 * D : D;        // P slice row room (f32 columns)
  constexpr int PS = BKV < PW ? BKV : PW;       // P slice row (one column chunk)
  constexpr int JC = PS / CL;                   // a lane's score columns per chunk
  constexpr int NCH = BKV / PS;                 // column chunks at bkv == BKV
  constexpr int OC = D / 4 / CL;                // output chunks a lane holds
  constexpr int NC = D / 4;                     // chunks of one row
  static_assert(RI >= 1 && OC >= 1 && JC >= 1 && CL % 8 == 0 && NC % 8 == 0 &&
                    BKV % PS == 0 && PS % 32 == 0,
                "an instantiation's blocks and lane layout");
  const int bq = FULL ? BQ : bq_arg;
  const int bkv = FULL ? BKV : bkv_arg;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const char* sb = reinterpret_cast<const char*>(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw);  // [bq][D]
  T* ks = qs + bq * D;                     // [2][bkv][D]
  T* vs = ks + 2 * bkv * D;                // [2][bkv][D]
  const unsigned p0 = E * (unsigned)(bq * D + 4 * bkv * D);  // byte offset of P
  float* ps = reinterpret_cast<float*>(smem_raw + p0);  // 8 warp slices of [bq/8][PS]

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest q blocks first
  const int q_start = qb * bq;    // the block's first row
  const int q_pos = q_off + q_start;  // and its position
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / CL, cl = lane % CL;
  const int wrows = bq / 8, wr0 = warp * wrows;
  float* pw = ps + wr0 * PS;  // this warp's P slice

  // The KV blocks the TPU kernel's `run` predicate admits.
  const int n_kvb = skv / bkv;
  int hi = n_kvb - 1, lo = 0;
  if (causal) hi = min(hi, (q_pos + bq - 1) / bkv);
  if (window >= 0) {
    const int x = q_pos - window + 2 - bkv;
    lo = x > 0 ? (x + bkv - 1) / bkv : 0;
  }
  const int n_run = hi - lo + 1;

  const T* qg = Q + ((size_t)bh * sq + q_start) * D;
  const size_t kv_row = (size_t)(bh / group) * skv;
  load_tile<T, D, RG>(qs, qg, bq);
  if (n_run > 0) {
    load_tile<T, D, 8>(ks, K + (kv_row + (size_t)lo * bkv) * D, bkv);
    load_tile<T, D, 8>(vs, V + (kv_row + (size_t)lo * bkv) * D, bkv);
  }
  cp_async_commit();

  // Per-lane byte offsets, fixed for the kernel.  Row i of the lane is warp
  // row g + RG*i: Q row wr0 + g + RG*i, P slice row g + RG*i.
  const int row_lim = min(bq, q_len - q_start);
  const int gq = (wr0 + g) & (RG - 1);  // the Q swizzle of this lane's rows
  const int cl7 = cl & 7;               // the K/V swizzle of this lane's K rows
  const int sp = g * CL;                // the P column swizzle of this row group
  unsigned q_at[8], k_at[8];            // chunk c8 of the lane's first Q row / K row
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) {
    q_at[c8] = E * (wr0 + g) * D + CB * (c8 ^ gq);
    k_at[c8] = E * cl * D + CB * (c8 ^ cl7);
  }
  unsigned v_at[8];  // V row c + u (c a multiple of 8), the lane's chunk cl
#pragma unroll
  for (int u = 0; u < 8; ++u) v_at[u] = E * u * D + CB * (cl ^ u);
  const unsigned p_at = p0 + 4u * (unsigned)(wr0 * PS + g * PS);
  // A row of the lane past the warp's reads (and never writes) the warp's
  // first row; a score column past bkv is masked (its K row is bkv's first
  // row in a partly valid column block, and a wholly invalid one is skipped).
  unsigned q_row[RI], p_row[RI];
  bool row_ok[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lr = g + RG * i;
    const bool in = FULL || lr < wrows;
    q_row[i] = in ? E * RG * i * D : E * (unsigned)(-g * D);
    p_row[i] = in ? 4u * RG * i * PS : 4u * (unsigned)(-g * PS);
    row_ok[i] = in && wr0 + lr < row_lim;
  }

  float acc[RI][OC][4];
  float m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
#pragma unroll
    for (int h = 0; h < OC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  }

  for (int t = 0; t < n_run; ++t) {
    const int st = t & 1;
    const int k_start = (lo + t) * bkv;
    // The one barrier of a KV block: stage st has landed for every thread,
    // and every warp is done with stage st ^ 1, which the next copy fills.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_run) {
      const size_t nxt = (kv_row + (size_t)(k_start + bkv)) * D;
      load_tile<T, D, 8>(ks + (st ^ 1) * bkv * D, K + nxt, bkv);
      load_tile<T, D, 8>(vs + (st ^ 1) * bkv * D, V + nxt, bkv);
      cp_async_commit();
    }
    const unsigned kt = E * (unsigned)(bq * D + st * bkv * D);
    const unsigned vt = E * (unsigned)(bq * D + 2 * bkv * D + st * bkv * D);
    const int cj_run = FULL ? CJ : (bkv + CL - 1) / CL;  // column blocks with a valid column

    // S = Q K^T for this lane's RI x CJ scores, eight chunks of D a step.
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int m = 0; m < NC / 8; ++m) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const unsigned qa = q_at[c8] + 8 * CB * m, ka = kt + k_at[c8] + 8 * CB * m;
        float4 a[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = lds4<T>(sb, qa + q_row[i]);
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          if (!FULL && j >= cj_run) break;
          const float4 b = lds4<T>(sb, ka + E * CL * j * D);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
          }
        }
      }
    }

    // Masks (where one reaches this block) and the online softmax in base 2;
    // s becomes P.
    const int col_lim = min(bkv, kv_len - k_start);
    const bool open = col_lim == BKV && row_lim == bq &&
                      (!causal || k_start + bkv - 1 <= q_pos) &&
                      (window < 0 || q_pos + bq - 1 - k_start < window);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qid = q_pos + wr0 + g + RG * i;
      float mx = kNeg;
      if (open) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] *= scale_log2;
          mx = fmaxf(mx, s[i][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = cl + CL * j;
          const int kid = k_start + c;
          bool ok = row_ok[i] && c < col_lim;
          if (causal) ok = ok && kid <= qid;
          if (window >= 0) ok = ok && qid - kid < window;
          s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
      }
#pragma unroll
      for (int o = CL / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2_approx(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = exp2_approx(s[i][j] - m_new);  // exactly 0 where masked
        sum += s[i][j];
      }
#pragma unroll
      for (int o = CL / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int h = 0; h < OC; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= alpha;
    }

    // acc += P V, one column chunk of P at a time through the warp's slice.
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch * PS >= bkv) break;
      __syncwarp();  // the slice's last reads are done
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int lr = g + RG * i;
        if (FULL || lr < wrows) {
#pragma unroll
          for (int jj = 0; jj < JC; ++jj)
            pw[lr * PS + ((cl + CL * jj) ^ sp)] = s[i][ch * JC + jj];
        }
      }
      __syncwarp();
      const int n_rows = min(PS, bkv - ch * PS);
#pragma unroll 1
      for (int c = 0; c < n_rows; c += 8) {
        const unsigned pa = p_at + 4u * (c ^ sp);  // columns c.. of P sit at (c ^ sp)..
        const unsigned vb = vt + E * (ch * PS + c) * D;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float4 p[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) p[i] = lds4<float>(sb, pa + p_row[i] + 16u * half);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float4 v[OC];
#pragma unroll
            for (int h = 0; h < OC; ++h) v[h] = lds4<T>(sb, vb + v_at[4 * half + u] + CB * CL * h);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
              for (int h = 0; h < OC; ++h) {
                acc[i][h][0] = fmaf(pu, v[h].x, acc[i][h][0]);
                acc[i][h][1] = fmaf(pu, v[h].y, acc[i][h][1]);
                acc[i][h][2] = fmaf(pu, v[h].z, acc[i][h][2]);
                acc[i][h][3] = fmaf(pu, v[h].w, acc[i][h][3]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // Flush: every lane of a row group holds its rows' l; l == 0 (no visible
  // key, or a padding row) writes 0.
  T* og = O + ((size_t)bh * sq + q_start + wr0) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lr = g + RG * i;
    if (!FULL && lr >= wrows) continue;
    const float inv = l_run[i] == 0.f ? 0.f : 1.f / l_run[i];
#pragma unroll
    for (int h = 0; h < OC; ++h) {
      float4 out;
      out.x = acc[i][h][0] * inv;
      out.y = acc[i][h][1] * inv;
      out.z = acc[i][h][2] * inv;
      out.w = acc[i][h][3] * inv;
      st4(og + (size_t)lr * D + (cl + CL * h) * 4, out);
    }
  }
}

template <class T, int D, int BQ, int BKV, int RG, bool FULL>
int launch_as(const T* q, const T* k, const T* v, T* o, int bhq, int bhkv, int sq, int skv,
              int bq, int bkv, int q_len, int kv_len, int causal, int window, int q_off,
              float scale_log2, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_kernel<T, D, BQ, BKV, RG, FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bhq, sq / bq);
  fa_fwd_kernel<T, D, BQ, BKV, RG, FULL><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, bhq / bhkv, sq, skv, bq, bkv, q_len, kv_len, causal, window, q_off,
      scale_log2);
  return (int)cudaGetLastError();
}

// The planner's H100 term at sizeof(T) an element: Q and two stages of K and
// V in T, the f32 P room and (m, l).
template <class T>
size_t smem_bytes(int d, int bq, int bkv) {
  return 2 * sizeof(T) * ((size_t)bq * d + 2 * (size_t)bkv * d) +
         sizeof(float) * ((size_t)bq * d + 2 * (size_t)bq);
}

template <class T, int D, int BQ, int BKV, int RG>
int launch(const T* q, const T* k, const T* v, T* o, int bhq, int bhkv, int sq, int skv,
           int bq, int bkv, int q_len, int kv_len, int causal, int window, int q_off,
           float scale_log2, cudaStream_t stream) {
  if (bq < 8 || bq > BQ || bq % 8 || bkv < 8 || bkv > BKV || bkv % 8 || sq % bq ||
      skv % bkv || bhkv <= 0 || bhq % bhkv || q_off < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(D, bq, bkv);
  if constexpr (std::is_same<T, float>::value) {
    if (bq == BQ && bkv == BKV)
      return launch_as<T, D, BQ, BKV, RG, true>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv,
                                                q_len, kv_len, causal, window, q_off,
                                                scale_log2, smem, stream);
  }
  return launch_as<T, D, BQ, BKV, RG, false>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                             kv_len, causal, window, q_off, scale_log2,
                                             smem, stream);
}

// -- bf16 on the tensor cores (see the header) -----------------------------------

constexpr int kFma = 0, kWgmma = 1;  // the entry points' `tmpl` (FLASH_TEMPLATES' index)
constexpr int kWgThreads = 128;       // one warpgroup: 64 query rows
constexpr int kPTerms = 2;            // P as P_hi + P_lo (1: P rounded to bf16)

// A [rows][D] bf16 tile as wgmma reads it: D = 32 as 64-byte rows at the
// 64-byte swizzle; D >= 64 as D/64 panels [rows][64] of 128-byte rows at the
// 128-byte swizzle, panel p at p * rows * 128 B.
template <int D>
struct TcTile {
  static constexpr int kCols = D < 64 ? D : 64;  // a panel's columns (one TMA box)
  static constexpr int kRowBytes = 2 * kCols;
  static constexpr int kPanels = D / kCols;
  static constexpr int kSteps = kCols / 16;  // k16 steps along a panel's row
  static constexpr int kGroup = 8 * kRowBytes;  // 8-row groups apart (the descriptors' SBO)
  static constexpr uint64_t kSwizzle = D < 64 ? sm90::kSwizzle64 : sm90::kSwizzle128;
  static constexpr CUtensorMapSwizzle kMapSwizzle =
      D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};

// (a, b) as two bf16 pairs hi + lo: hi = bf16(a, b), lo = bf16 of what hi
// leaves; each a b32 of wgmma's A fragment (the lower column in the low half).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// o[0..D/2) += P . V for one k16 step of keys: P's fragment `a`, V's 16 rows
// at `vb` (panels `panel` bytes apart), MN-major; D = 256 as two n128 halves.
template <int D>
__device__ __forceinline__ void pv_step(float* o, const uint32_t (&a)[4], uint32_t vb,
                                        uint32_t panel) {
  using L = TcTile<D>;
  constexpr int N = D < 128 ? D : 128;
#pragma unroll
  for (int h = 0; h < D / N; ++h)
    sm90::Wgmma<N>::template rs<1>(
        o + N / 2 * h, a,
        sm90::descriptor(vb + h * (N / L::kCols) * panel, panel, L::kGroup, L::kSwizzle), 1);
}

// One block per (b*Hq + h, q block), heaviest q blocks first, bq/64
// warpgroups; the KV blocks the TPU kernel's `run` predicate admits, as
// fa_fwd_kernel. BKV is the instantiation's block_kv, FULL that the launch
// takes it (S in one m64n{BKV}k16 a step); otherwise S goes in 16-key
// chunks. Two instantiations, not a branch: with both S paths in one kernel
// ptxas serialized every wgmma (its note C7511).
template <int D, int BKV, bool FULL>
__global__ void __launch_bounds__(2 * kWgThreads, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ O,
                    int group, int sq, int skv, int bq, int bkv, int q_len, int kv_len,
                    int causal, int window, int q_off, float scale_log2) {
  using L = TcTile<D>;
  constexpr int NS = BKV / 2, NO = D / 2;  // S and O floats a thread
  constexpr int NK = BKV / 16;              // k16 steps of P . V at bkv == BKV
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  const uint32_t raw = sm90::smem_addr(fa_smem);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t tile = (uint32_t)bkv * L::kRowBytes * L::kPanels;  // one K or V tile
  // Q, then K's two stages, V's two, then the barriers (Q's, each stage's).
  const uint32_t q_at = raw + pad, k_at = q_at + (uint32_t)bq * 2 * D;
  const uint32_t v_at = k_at + 2 * tile, bars = v_at + 2 * tile;
  const uint32_t q_panel = (uint32_t)bq * L::kRowBytes;  // panels of Q, of a K or V tile
  const uint32_t kv_panel = (uint32_t)bkv * L::kRowBytes;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest q blocks first
  const int q_start = qb * bq, q_pos = q_off + q_start;
  const int n_kvb = skv / bkv;
  int hi = n_kvb - 1, lo = 0;
  if (causal) hi = min(hi, (q_pos + bq - 1) / bkv);
  if (window >= 0) {
    const int x = q_pos - window + 2 - bkv;
    lo = x > 0 ? (x + bkv - 1) / bkv : 0;
  }
  const int n_run = hi - lo + 1;
  const int q_row = bh * sq + q_start, kv_row = (bh / group) * skv;
  const CUtensorMap *pq = &map_q, *pk = &map_k, *pv = &map_v;

  // Thread 0: KV block t into stage t & 1.
  auto issue_kv = [&](int t) {
    const int s = t & 1, row = kv_row + (lo + t) * bkv;
    const uint32_t bar = bars + 8 + 8 * s;
    sm90::mbar_expect_tx(bar, 2 * tile);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      sm90::tma_load(k_at + s * tile + p * kv_panel, pk, bar, p * L::kCols, row);
      sm90::tma_load(v_at + s * tile + p * kv_panel, pv, bar, p * L::kCols, row);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_run > 0) {
    sm90::mbar_expect_tx(bars, (uint32_t)bq * 2 * D);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      sm90::tma_load(q_at + p * q_panel, pq, bars, p * L::kCols, q_row);
    for (int t = 0; t < 2 && t < n_run; ++t) issue_kv(t);
  }

  // This thread's rows r0 and r0 + 8 of the q block and columns c0, c0 + 1
  // of each 8 (the wgmma layout).
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), c0 = (lane & 3) * 2;
  const int row_lim = min(bq, q_len - q_start);
  const int n16 = FULL ? NK : bkv / 16;
  const uint32_t qa = q_at + wg * 64 * L::kRowBytes;  // this warpgroup's rows of Q
  float s[NS], o[NO], m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  if (n_run > 0) sm90::mbar_wait(bars, 0);

  for (int t = 0; t < n_run; ++t) {
    const int st = t & 1, k_start = (lo + t) * bkv;
    sm90::mbar_wait(bars + 8 + 8 * st, (t >> 1) & 1);
    const uint32_t kt = k_at + st * tile, vt = v_at + st * tile;

    // S = Q K^T, D/16 steps; panel kk / kSteps, 32 B a step along its rows.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / L::kSteps) * q_panel + (kk % L::kSteps) * 32;
      const uint32_t bt = kt + (kk / L::kSteps) * kv_panel + (kk % L::kSteps) * 32;
      const uint64_t da = sm90::descriptor(qa + at, 16, L::kGroup, L::kSwizzle);
      if constexpr (FULL) {
        sm90::Wgmma<BKV>::template ss<0, 0>(
            s, da, sm90::descriptor(bt, 16, L::kGroup, L::kSwizzle), kk > 0);
      } else {
#pragma unroll
        for (int c = 0; c < BKV / 16; ++c)
          if (c < n16)
            sm90::Wgmma<16>::template ss<0, 0>(
                s + 8 * c, da,
                sm90::descriptor(bt + c * 16 * L::kRowBytes, 16, L::kGroup, L::kSwizzle),
                kk > 0);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // Masks (where one reaches this block; always below BKV, whose columns
    // past bkv were never computed) and the online softmax in base 2, row
    // r0 + 8h from s[4j + 2h], s[4j + 2h + 1]; s becomes P.
    const int col_lim = min(bkv, kv_len - k_start);
    const bool open = FULL && col_lim == bkv && row_lim == bq &&
                      (!causal || k_start + bkv - 1 <= q_pos) &&
                      (window < 0 || q_pos + bq - 1 - k_start < window);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = r0 + 8 * h, qid = q_pos + lr;
      float mx = kNeg;
      if (open) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[4 * j + 2 * h + e] *= scale_log2;
            mx = fmaxf(mx, s[4 * j + 2 * h + e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + c0 + e, kid = k_start + c;
            bool ok = lr < row_lim && c < col_lim;
            if (causal) ok = ok && kid <= qid;
            if (window >= 0) ok = ok && qid - kid < window;
            float& x = s[4 * j + 2 * h + e];
            x = ok ? x * scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = exp2_approx(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x = exp2_approx(x - m_new);  // exactly 0 where masked
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }

    // O = alpha O + P V: the CUDA cores rescale, the tensor cores add P_hi V
    // and P_lo V, key step kk's fragment from s[8kk .. 8kk + 7].
    uint32_t p_hi[NK][4], p_lo[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk < n16) {
        const uint32_t vb = vt + kk * 16 * L::kRowBytes;
        pv_step<D>(o, p_hi[kk], vb, kv_panel);
        if (kPTerms == 2) pv_step<D>(o, p_lo[kk], vb, kv_panel);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    // Every warpgroup is done with stage st: thread 0 refills it.
    __syncthreads();
    if (tid == 0 && t + 2 < n_run) issue_kv(t + 2);
  }

  // Flush through the tiles' room, rows padded: O / l rounded once to bf16
  // (l == 0 -- no visible key, or a padding row -- writes 0), 16-byte stores.
  constexpr int kPitch = D + 8;
  bf16* stage = reinterpret_cast<bf16*>(fa_smem + pad);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = l_run[h] == 0.f ? 0.f : 1.f / l_run[h];
    bf16* row = stage + (r0 + 8 * h) * kPitch + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
  __syncthreads();
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row
  bf16* og = O + (size_t)q_row * D;
  for (int e = tid; e < bq * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks;
    *reinterpret_cast<uint4*>(og + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * kPitch + c * 8);
  }
}

template <int D, int BKV, bool FULL>
int launch_tc_as(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, bf16* o,
                 int bhq, int bhkv, int sq, int skv, int bq, int bkv, int q_len, int kv_len,
                 int causal, int window, int q_off, float scale_log2, cudaStream_t stream) {
  const size_t smem = smem_bytes<bf16>(D, bq, bkv);
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma_kernel<D, BKV, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bhq, sq / bq);
  fa_wgmma_kernel<D, BKV, FULL><<<grid, bq / 64 * kWgThreads, smem, stream>>>(
      mq, mk, mv, o, bhq / bhkv, sq, skv, bq, bkv, q_len, kv_len, causal, window, q_off,
      scale_log2);
  return (int)cudaGetLastError();
}

// The wgmma kernel at its instantiation's (BQ, BKV) maxima, for bq a
// multiple of 64 and bkv of 16 up to them; the planner's bf16 bytes.
template <int D, int BQ, int BKV>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o, int bhq, int bhkv,
              int sq, int skv, int bq, int bkv, int q_len, int kv_len, int causal, int window,
              int q_off, float scale_log2, cudaStream_t stream) {
  using L = TcTile<D>;
  if (bq < 64 || bq > BQ || bq % 64 || bkv < 16 || bkv > BKV || bkv % 16 || sq % bq ||
      skv % bkv || bhkv <= 0 || bhq % bhkv || q_off < 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = sm90::tensor_map(&mq, q, bhq * sq, D, bq, L::kCols, L::kMapSwizzle);
  if (err == cudaSuccess)
    err = sm90::tensor_map(&mk, k, bhkv * skv, D, bkv, L::kCols, L::kMapSwizzle);
  if (err == cudaSuccess)
    err = sm90::tensor_map(&mv, v, bhkv * skv, D, bkv, L::kCols, L::kMapSwizzle);
  if (err != cudaSuccess) return (int)err;
  if (bkv == BKV)
    return launch_tc_as<D, BKV, true>(mq, mk, mv, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                      kv_len, causal, window, q_off, scale_log2, stream);
  return launch_tc_as<D, BKV, false>(mq, mk, mv, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                     kv_len, causal, window, q_off, scale_log2, stream);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  sq/skv are
// the padded lengths, q_len/kv_len the real ones; window < 0 means none;
// q_off is the position of q's first row; `tmpl` the kernel
// (flash_attention.py::FLASH_TEMPLATES' index: kFma, or kWgmma for bf16);
// `scale` is the softmax scale (the kernel folds log2(e) into it).
int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                              float* o, int bhq, int bhkv, int sq, int skv, int d,
                              int bq, int bkv, int q_len, int kv_len, int causal,
                              int window, int q_off, int tmpl, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;  // log2(e)
  if (tmpl != kFma) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch<float, 32, 128, 128, 4>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                            kv_len, causal, window, q_off, sl2, s);
    case 64:
      return launch<float, 64, 128, 128, 4>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                            kv_len, causal, window, q_off, sl2, s);
    case 128:
      return launch<float, 128, 64, 64, 2>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                           kv_len, causal, window, q_off, sl2, s);
    case 256:
      return launch<float, 256, 32, 32, 1>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                           kv_len, causal, window, q_off, sl2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same for bf16 q, k, v and o (f32 inside): the wgmma kernel at
// tmpl == kWgmma, else the FMA kernel.
int repro_flash_attention_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                               int bhq, int bhkv, int sq, int skv, int d, int bq, int bkv,
                               int q_len, int kv_len, int causal, int window, int q_off,
                               int tmpl, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * 1.4426950408889634f;  // log2(e)
  if (tmpl == kWgmma) {
    switch (d) {
      case 32:
        return launch_tc<32, 128, 128>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                       kv_len, causal, window, q_off, sl2, s);
      case 64:
        return launch_tc<64, 128, 128>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                       kv_len, causal, window, q_off, sl2, s);
      case 128:
        return launch_tc<128, 128, 64>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                       kv_len, causal, window, q_off, sl2, s);
      case 256:
        return launch_tc<256, 64, 32>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                      kv_len, causal, window, q_off, sl2, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (tmpl != kFma) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch<bf16, 32, 128, 128, 4>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                           kv_len, causal, window, q_off, sl2, s);
    case 64:
      return launch<bf16, 64, 128, 128, 4>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                           kv_len, causal, window, q_off, sl2, s);
    case 128:
      return launch<bf16, 128, 128, 64, 2>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                           kv_len, causal, window, q_off, sl2, s);
    case 256:
      return launch<bf16, 256, 64, 32, 2>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                          kv_len, causal, window, q_off, sl2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
