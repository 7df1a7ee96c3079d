// Pass B of the exact two-pass top-k: each query's candidate segments
// rescored exactly, and its top k of them, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. In the JAX package pass B is XLA after the
// pass-A kernel: a take of the selected segments, an einsum with
// preferred_element_type=f32 and lax.top_k
// (semanticsearch_tpu/ops/topk.py:707-752). The port's plain version
// (ops/topk.py::pass_b_rescore_plain) does the same in torch ops, which on
// the card write each 256-query chunk's gathered rows widened to f32 and a
// score matrix to device memory and read both back; this kernel writes
// neither.
//
// What it computes. Queries q (Q, D) and corpus c (>= n rows, D), row-major,
// both bf16 or both f32; seg_ids (Q, k_sel) int32 from pass A, ids < 0 being
// placeholders. Candidate j' = s*L2 + j of a query is row
// max(seg_ids[q, s], 0)*L2 + j; it is valid iff seg_ids[q, s] >= 0 and the
// row is < n. A valid candidate scores the dot product of its row with the
// query, each product taken in f32 (exact for bf16 operands) and summed in
// f32 by FMAs (no TF32); an invalid one scores -1e30 and is never read.
// Output per query: the top k (value f32, row id int32), by value
// descending, ties to the earlier candidate position (the stable sort of
// the plain version, lax.top_k's rule); -1e30 slots carry their rows' ids,
// the clamped rows in candidate order, as the plain version's do.
//
// What bounds it on this card. Bytes: a query's k_sel*L2 rows are D
// multiply-adds each against D*elem bytes read, one operation a byte (bf16)
// or half of one (f32), far below the H100's ~295 bf16 FLOP/byte ridge. At
// the shard (32,768 queries, k_sel 11, L2 32, D 384 bf16) the gathered rows
// are 8.86 GB: 2.64 ms at 3.35 TB/s. The queries and the outputs add 1%.
//
// What the design does about it.
//  * One CTA a query, 8 warps. The query is widened to f32 once, into shared
//    memory. Each warp scores ROWS candidate rows at a time: its lanes read
//    16 bytes each from consecutive addresses of every row (a row of 768
//    bytes is two coalesced warp loads), all ROWS rows' loads issued before
//    their FMAs, so each warp keeps up to 2*ROWS loads in flight and a SM
//    holds tens of KB of loads at once: enough for the memory's latency
//    times its rate. Rows whose width is not a multiple of 16 bytes, or a
//    corpus that is not 16-byte aligned, take the same loop on one value a
//    lane (vec = 1).
//  * Each lane sums its own columns in order; a butterfly of shuffles sums
//    the lanes. The order is fixed, so the result is the same in every run.
//    The k_sel*L2 scores stay in shared memory (64 KB at k_sel 128, L2 128);
//    no widened row and no score matrix reaches device memory.
//  * Selection in the CTA on 64-bit keys, (the order-preserving u32 of the
//    score) << 32 | ~position: distinct keys, largest first is value
//    descending then position ascending. Each thread keeps the largest key
//    among its positions; k rounds of a block maximum (warp shuffles, one
//    barrier, a double-buffered slot a warp) take the winner, and only its
//    owner rescans its positions for the largest key below it. -0 scores as
//    +0 and every NaN above every number, as torch.sort orders them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 4;  // candidate rows a warp scores at once
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_LIMIT = 232448;
constexpr int RED_BYTES = 2 * NWARPS * 8;  // two slots a warp, 64-bit keys

template <typename T, int VEC>
struct Vec;

// eight bf16 values: one 16-byte load
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a bf16 is the high half of its f32: element 2i is the low half of
  // word i, element 2i+1 the high half
  __device__ __forceinline__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ __forceinline__ static float hi(unsigned w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ __forceinline__ float dot(const float* qv, float acc) const {
    const float4 qa = *reinterpret_cast<const float4*>(qv);
    const float4 qb = *reinterpret_cast<const float4*>(qv + 4);
    acc = fmaf(lo(raw.x), qa.x, acc);
    acc = fmaf(hi(raw.x), qa.y, acc);
    acc = fmaf(lo(raw.y), qa.z, acc);
    acc = fmaf(hi(raw.y), qa.w, acc);
    acc = fmaf(lo(raw.z), qb.x, acc);
    acc = fmaf(hi(raw.z), qb.y, acc);
    acc = fmaf(lo(raw.w), qb.z, acc);
    acc = fmaf(hi(raw.w), qb.w, acc);
    return acc;
  }
};

// four f32 values: one 16-byte load
template <>
struct Vec<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float dot(const float* qv, float acc) const {
    const float4 qa = *reinterpret_cast<const float4*>(qv);
    acc = fmaf(raw.x, qa.x, acc);
    acc = fmaf(raw.y, qa.y, acc);
    acc = fmaf(raw.z, qa.z, acc);
    acc = fmaf(raw.w, qa.w, acc);
    return acc;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// one value a lane: any width, any alignment
template <typename T>
struct Vec<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = p[0]; }
  __device__ __forceinline__ float dot(const float* qv, float acc) const {
    return fmaf(to_f32(raw), qv[0], acc);
  }
};

__device__ __forceinline__ unsigned long long key_of(float s, int pos) {
  const float z = s + 0.0f;  // -0 -> +0: torch.sort holds them equal
  unsigned u = __float_as_uint(z);
  u = s != s ? 0xFFFFFFFFu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(pos));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    pass_b_kernel(const T* __restrict__ q, const T* __restrict__ c,
                  const int* __restrict__ seg_ids, float* __restrict__ out_v,
                  int* __restrict__ out_i, int D, int d_pad, long long n, int L2, int k_sel,
                  int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* red = reinterpret_cast<unsigned long long*>(smem);
  float* qf = reinterpret_cast<float*>(smem + RED_BYTES);
  float* score = qf + d_pad;
  const int n_cand = k_sel * L2;
  int* segs = reinterpret_cast<int*>(score + n_cand);
  const long long qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int d = threadIdx.x; d < D; d += THREADS) qf[d] = to_f32(q[qi * D + d]);
  for (int s = threadIdx.x; s < k_sel; s += THREADS) segs[s] = seg_ids[qi * k_sel + s];
  __syncthreads();

  // ---- scores: ROWS candidate rows a warp at a time
  const int nvec = D / VEC;
  for (int c0 = warp * ROWS; c0 < n_cand; c0 += NWARPS * ROWS) {
    const T* row[ROWS];
    bool ok[ROWS];
    float acc[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int pos = c0 + u;
      const int seg = pos < n_cand ? segs[pos / L2] : -1;
      const long long r = static_cast<long long>(seg < 0 ? 0 : seg) * L2 + pos % L2;
      ok[u] = seg >= 0 && r < n;
      row[u] = c + (ok[u] ? r : 0) * static_cast<long long>(D);
      acc[u] = 0.0f;
    }
    for (int v = lane; v < nvec; v += 32) {
      Vec<T, VEC> x[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (ok[u]) x[u].load(row[u] + static_cast<long long>(v) * VEC);
      const float* qv = qf + v * VEC;
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (ok[u]) acc[u] = x[u].dot(qv, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        if (c0 + u < n_cand) score[c0 + u] = ok[u] ? acc[u] : NEG_INF;
    }
  }
  __syncthreads();

  // ---- the top k: k rounds of a block maximum over distinct 64-bit keys
  unsigned long long best = 0;  // every key is > 0
  for (int pos = threadIdx.x; pos < n_cand; pos += THREADS)
    best = umax64(best, key_of(score[pos], pos));
  for (int it = 0; it < k; ++it) {
    unsigned long long w = best;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = umax64(w, __shfl_xor_sync(0xffffffffu, w, o));
    unsigned long long* slot = red + (it & 1) * NWARPS;
    if (lane == 0) slot[warp] = w;
    __syncthreads();
    w = slot[0];
#pragma unroll
    for (int j = 1; j < NWARPS; ++j) w = umax64(w, slot[j]);
    if (threadIdx.x == 0) {
      const int pos = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(w));
      const int seg = segs[pos / L2];
      out_v[qi * k + it] = score[pos];
      out_i[qi * k + it] = (seg < 0 ? 0 : seg) * L2 + pos % L2;
    }
    if (best == w) {  // this thread's key won: its next is the largest below
      best = 0;
      for (int pos = threadIdx.x; pos < n_cand; pos += THREADS) {
        const unsigned long long key = key_of(score[pos], pos);
        if (key < w) best = umax64(best, key);
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* c, const void* seg_ids, void* out_v, void* out_i, int Q,
           long long n, int D, int L2, int k_sel, int k, cudaStream_t st) {
  const int d_pad = (D + 3) / 4 * 4;
  const size_t bytes = RED_BYTES + 4 * (size_t)d_pad + 4 * (size_t)k_sel * L2 + 4 * (size_t)k_sel;
  if (bytes > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (VEC > 1 && (reinterpret_cast<uintptr_t>(c) % 16 || (D * sizeof(T)) % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pass_b_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  pass_b_kernel<T, VEC><<<Q, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), static_cast<const int*>(seg_ids),
      static_cast<float*>(out_v), static_cast<int*>(out_i), D, d_pad, n, L2, k_sel, k);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 = 0: bf16 operands, 1: f32; vec = 1 (one value a lane) or 16 bytes a
// lane (8 bf16 or 4 f32: D * elem a multiple of 16 and c 16-byte aligned).
// Shared memory (ops/topk.py::pass_b_smem_bytes) must fit 232,448 bytes.
extern "C" int pass_b_rescore(const void* q, const void* c, const void* seg_ids, void* out_v,
                              void* out_i, int Q, long long n, int D, int L2, int k_sel, int k,
                              int f32, int vec, void* stream) {
  if (Q <= 0 || n < 0 || D <= 0 || L2 <= 0 || k_sel <= 0 || k <= 0 ||
      (long long)k > (long long)k_sel * L2 || (long long)k_sel * L2 > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    if (vec == 4) return launch<float, 4>(q, c, seg_ids, out_v, out_i, Q, n, D, L2, k_sel, k, st);
    if (vec == 1) return launch<float, 1>(q, c, seg_ids, out_v, out_i, Q, n, D, L2, k_sel, k, st);
  } else {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(q, c, seg_ids, out_v, out_i, Q, n, D, L2, k_sel, k, st);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(q, c, seg_ids, out_v, out_i, Q, n, D, L2, k_sel, k, st);
  }
  return (int)cudaErrorInvalidValue;
}
