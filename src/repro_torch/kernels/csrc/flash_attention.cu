// Flash-attention forward, f32, for the H100 (sm_90a): causal and sliding-
// window masks, GQA, padding masks, online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_fa_kernel
// (flash_attention_pallas), the attention cell of the planned transformer
// training step.
//
// What bounds it here: at the main path's shape ([B*Hq, S, D] = [64, 2048,
// 64], causal) each K/V tile is reused by a whole q block, so the kernel
// does about 4*S/2*D = 262k flop per 2*D*4 B of K/V it streams; the bound
// is f32 operations (67 TFLOP/s on the CUDA cores), not the 3.35 TB/s of
// device memory.  This first kernel issues plain FMAs (no tensor cores, no
// TF32: the gates are f32 at 1e-4); what keeps it below 67 TFLOP/s is
// shared-memory bandwidth and one 256-thread block per SM.
//
// Design: one thread block per (b*Hq + h, q block) — the Pallas kernel's
// two parallel grid axes.  Its sequential kv grid axis becomes a loop inside
// the block, and the loop runs only over the KV blocks that the kernel's
// `run` predicate admits (AttentionPlanner.kv_blocks_run): blocks wholly in
// the causal future or wholly before the window are never fetched, which
// is what the TPU kernel's clamped kv index map saves there.  q blocks run
// heaviest first (the last causal block sees the most keys).
//
// Shared memory (dynamic, all of it; == AttentionPlanner._vmem_bytes on
// the H100 machine, 230,400 B at D = 64 with 128/128 blocks):
//   Q   [bq][D]          the q block, loaded once;
//   K,V [2][bkv][D] each two stages filled by cp.async, so the next KV
//                        block's copy overlaps this block's FMAs;
//   P   [2*bq*D] floats  the probability tile [bq][bkv] (bkv <= 2*D) that
//                        the P.V product reads across threads — it sits in
//                        the planner's second q stage and f32 accumulator
//                        terms, since the accumulator itself is in registers;
//   m,l [2][bq]          each row's running max and sum at the flush.
// Q, K and V rows are stored with their 16-byte chunks XOR-swizzled by
// (row & 7), so the float4 reads of eight neighbouring rows hit distinct
// banks.
//
// Threads: 256 = 16 row groups (ty) x 16 lanes (tx).  A thread owns rows
// ty + 16*i of the q block, score columns tx + 16*j of the KV block and
// output chunks tx + 16*h (float4) of D; the 16 lanes of a row group hold
// the same rows, so each row's max and sum reduce with four xor shuffles
// and every lane ends with the same value.  Masked scores are -inf, the
// running max starts at -1e30, so a masked entry's probability is exactly
// 0 and a row with no visible key keeps l == 0 and is written as 0.
//
// Contract (checked by the Python wrapper): D in {64, 128}; bq, bkv
// multiples of 8 up to the instantiation's maxima (128/128 at D = 64,
// 64/64 at D = 128); sequences padded to the blocks; q [BHq, Sq, D],
// k/v [BHkv, Skv, D] contiguous and 16-byte aligned; BHkv divides BHq.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

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

// Element offset of chunk c (4 floats) of row r in a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 2);
}

// rows x D floats from contiguous global rows into a swizzled tile.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows) {
  constexpr int nq = D / 4;
  for (int e = threadIdx.x; e < rows * nq; e += kThreads) {
    const int r = e / nq, c = e % nq;
    cp_async16(dst + swz<D>(r, c), src + (size_t)r * D + c * 4);
  }
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, float* __restrict__ O, int group,
                  int sq, int skv, int bq, int bkv, int q_len, int kv_len,
                  int causal, int window, float scale) {
  constexpr int RI = BQ / 16;   // rows per thread
  constexpr int CJ = BKV / 16;  // score columns per thread
  constexpr int OC = D / 64;    // float4 output chunks per thread
  constexpr int NC = D / 4;     // chunks of one row

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [bq][D]
  float* ks = qs + bq * D;             // [2][bkv][D]
  float* vs = ks + 2 * bkv * D;        // [2][bkv][D]
  float* ps = vs + 2 * bkv * D;        // [bq][bkv] in 2*bq*D floats
  float* stats = ps + 2 * bq * D;      // m [bq], l [bq]

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest q blocks first
  const int q_start = qb * bq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // The KV blocks the TPU kernel's `run` predicate admits.
  const int n_kvb = skv / bkv;
  int hi = n_kvb - 1, lo = 0;
  if (causal) hi = min(hi, (q_start + bq - 1) / bkv);
  if (window >= 0) {
    const int x = q_start - window + 2 - bkv;
    lo = x > 0 ? (x + bkv - 1) / bkv : 0;
  }
  const int n_run = hi - lo + 1;

  const float* qg = Q + ((size_t)bh * sq + q_start) * D;
  const size_t kv_row = (size_t)(bh / group) * skv;
  load_tile<D>(qs, qg, bq);
  if (n_run > 0) {
    load_tile<D>(ks, K + (kv_row + (size_t)lo * bkv) * D, bkv);
    load_tile<D>(vs, V + (kv_row + (size_t)lo * bkv) * D, bkv);
  }
  cp_async_commit();

  // Rows past bq (and score columns past bkv) read a valid row with the same
  // swizzle and are masked.
  int qoff[RI], koff[CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    qoff[i] = (r < bq ? r : (ty & 7)) * D;
  }
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int c = tx + 16 * j;
    koff[j] = (c < bkv ? c : (tx & 7)) * D;
  }
  const int qsw = ty & 7, ksw = tx & 7;
  const int row_lim = min(bq, q_len - q_start);

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
    if (t + 1 < n_run) {
      const size_t nxt = (kv_row + (size_t)(k_start + bkv)) * D;
      load_tile<D>(ks + (st ^ 1) * bkv * D, K + nxt, bkv);
      load_tile<D>(vs + (st ^ 1) * bkv * D, V + nxt, bkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + st * bkv * D;
    const float* vt = vs + st * bkv * D;

    // S = Q K^T for this thread's RI x CJ scores.
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < NC; ++c) {
      float4 b[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(kt + koff[j] + ((c ^ ksw) << 2));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(qs + qoff[i] + ((c ^ qsw) << 2));
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }

    // Masks, online softmax, P to shared memory.
    const int col_lim = min(bkv, kv_len - k_start);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qid = q_start + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        const int kid = k_start + c;
        bool ok = r < row_lim && c < col_lim;
        if (causal) ok = ok && kid <= qid;
        if (window >= 0) ok = ok && qid - kid < window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);  // exactly 0 where masked
        sum += p;
        const int c = tx + 16 * j;
        if (r < bq && c < bkv) ps[r * bkv + c] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int h = 0; h < OC; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= alpha;
    }
    __syncthreads();

    // acc += P V.
    for (int c = 0; c < bkv; c += 4) {
      float4 v[4][OC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int h = 0; h < OC; ++h)
          v[u][h] = *reinterpret_cast<const float4*>(vt + swz<D>(c + u, tx + 16 * h));
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        const float4 p = *reinterpret_cast<const float4*>(
            ps + (r < bq ? r : (ty & 7)) * bkv + c);
#pragma unroll
        for (int h = 0; h < OC; ++h) {
          acc[i][h][0] += p.x * v[0][h].x + p.y * v[1][h].x + p.z * v[2][h].x + p.w * v[3][h].x;
          acc[i][h][1] += p.x * v[0][h].y + p.y * v[1][h].y + p.z * v[2][h].y + p.w * v[3][h].y;
          acc[i][h][2] += p.x * v[0][h].z + p.y * v[1][h].z + p.z * v[2][h].z + p.w * v[3][h].z;
          acc[i][h][3] += p.x * v[0][h].w + p.y * v[1][h].w + p.z * v[2][h].w + p.w * v[3][h].w;
        }
      }
    }
    __syncthreads();
  }
  if (n_run <= 0) cp_async_wait<0>();

  // Flush: each row's (m, l) through shared memory; l == 0 (no visible key,
  // or a padding row) writes 0.
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (tx == 0 && r < bq) {
      stats[r] = m_run[i];
      stats[bq + r] = l_run[i];
    }
  }
  __syncthreads();
  float* og = O + ((size_t)bh * sq + q_start) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= bq) continue;
    const float l = stats[bq + r];
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int h = 0; h < OC; ++h) {
      float4 out;
      out.x = acc[i][h][0] * inv;
      out.y = acc[i][h][1] * inv;
      out.z = acc[i][h][2] * inv;
      out.w = acc[i][h][3] * inv;
      *reinterpret_cast<float4*>(og + (size_t)r * D + (tx + 16 * h) * 4) = out;
    }
  }
}

template <int D, int BQ, int BKV>
int launch(const float* q, const float* k, const float* v, float* o, int bhq,
           int bhkv, int sq, int skv, int bq, int bkv, int q_len, int kv_len,
           int causal, int window, float scale, cudaStream_t stream) {
  if (bq < 8 || bq > BQ || bq % 8 || bkv < 8 || bkv > BKV || bkv % 8 ||
      bkv > 2 * D || sq % bq || skv % bkv || bhkv <= 0 || bhq % bhkv)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * (size_t)bq * D + 4 * (size_t)bkv * D + 2 * (size_t)bq);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D, BQ, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bhq, sq / bq);
  fa_fwd_kernel<D, BQ, BKV><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, bhq / bhkv, sq, skv, bq, bkv, q_len, kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  sq/skv are
// the padded lengths, q_len/kv_len the real ones; window < 0 means none.
int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                              float* o, int bhq, int bhkv, int sq, int skv, int d,
                              int bq, int bkv, int q_len, int kv_len, int causal,
                              int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64, 128, 128>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                                kv_len, causal, window, scale, s);
  if (d == 128)
    return launch<128, 64, 64>(q, k, v, o, bhq, bhkv, sq, skv, bq, bkv, q_len,
                               kv_len, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
