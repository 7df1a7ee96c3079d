// Fused exact top-k: per query, the k best corpus rows by inner product, for
// Hopper (sm_90a), any k up to 2048.
//
// Replaces: semanticsearch_tpu/ops/topk.py::_topk_kernel (the Pallas TPU
// kernel launched by topk_scores_pallas; the dense index's path for k >= 128
// with more than 8192 queries).
//
// What it computes. Queries q (Q, D) and corpus c (N, D), both bf16 and
// row-major; scores in f32. Rows at or past n_valid never appear. Output per
// query: the top-k (value, row id), ordered by value descending then row id
// ascending (the JAX kernel's k-pass selection: ties keep the lower row).
// When fewer than k rows exist, the tail slots hold value -1e30 and row 0.
//
// What bounds it on this card. 2*Q*N*D multiply-adds against one corpus read:
// at the deep-candidate shapes (thousands of queries, D = 384) it is bound
// by tensor-core throughput, like pass A. The selection is data-dependent:
// once a query's list is full, a row enters only if it beats the list's
// k-th value, so after the first ~k rows of a split almost every score costs
// one compare in registers.
//
// What the design does about it.
//  * The TPU grid swept the corpus in order and kept one running top-k list
//    per query in VMEM. CUDA blocks run in parallel in no order, so the grid
//    is (query tiles of 64) x (corpus splits), as in segtopk.cu: each CTA
//    scans a contiguous range of 128-row tiles with a WMMA bf16 main loop
//    (resident query tile, two-stage cp.async corpus ring, zero-filled rows
//    past n), and keeps one exact list per (query, split) in device memory
//    (k entries of (value, row), sorted). A second kernel merges the splits
//    per query by (value desc, row asc).
//  * Per tile, each warp owns 8 queries. For each, the lanes compare the
//    query's 128 scores with its threshold (the list's k-th value, kept in
//    shared memory) and compact the survivors with a ballot into a per-warp
//    candidate buffer. Rows ascend through a CTA's range, so a list entry
//    beats an equal-valued candidate: acceptance is `v > threshold`, and
//    equal values at the boundary resolve to the lower row.
//  * The survivors (at most 128) are ranked among themselves (value desc,
//    row asc) and merged into the sorted list in place: each survivor's new
//    slot is its rank plus the number of list entries >= it (binary search),
//    each displaced list entry moves right by the number of survivors
//    strictly above it, processed from the tail so nothing is overwritten
//    before it is read; slots past k fall off. Lists start as k sentinels
//    (-inf, INT_MAX), which the merge turns into (-1e30, 0).
//  * Shared memory does not grow with k (lists live in device memory, L2
//    resident for a CTA's 64 queries), so k = 2048 needs the same ~137 KB
//    as k = 128 at D = 384.
// Not yet done (later work): wgmma, TMA, and a register epilogue that skips
// the shared-memory score tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <climits>
#include <cmath>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // queries per CTA
constexpr int BN = 128;       // corpus rows per tile
constexpr int KC = 64;        // K (embedding) chunk per pipeline stage
constexpr int THREADS = 256;  // 8 warps: 2 (query) x 4 (corpus)
constexpr int WARPS = THREADS / 32;
constexpr int CPAD = KC + 8;  // bf16 row stride of a corpus stage
constexpr int SPAD = BN + 4;  // f32 row stride of the score tile
constexpr int MAX_K = 2048;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Layout {
  size_t q, c, s, thr, cv, ci, sv, si, total;
  __host__ __device__ explicit Layout(int Dp) {
    q = 0;
    c = align128(q + sizeof(__nv_bfloat16) * BQ * (Dp + 8));
    s = align128(c + sizeof(__nv_bfloat16) * 2 * BN * CPAD);
    thr = align128(s + sizeof(float) * BQ * SPAD);
    cv = align128(thr + sizeof(float) * BQ);
    ci = align128(cv + sizeof(float) * WARPS * BN);
    sv = align128(ci + sizeof(int) * WARPS * BN);
    si = align128(sv + sizeof(float) * WARPS * BN);
    total = align128(si + sizeof(int) * WARPS * BN);
  }
};

__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// number of leading entries of a non-increasing array that are >= v
__device__ inline int count_ge(const float* a, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (a[mid] >= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
// number of leading entries of a non-increasing array that are > v
__device__ inline int count_gt(const float* a, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (a[mid] > v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
topk_fused_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
                  float* __restrict__ list_v, int* __restrict__ list_i, int Q, int n_valid,
                  int D, int k, long long rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = (D + KC - 1) / KC * KC;
  const int qld = Dp + 8;
  Layout lay(Dp);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.c);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* thr_s = reinterpret_cast<float*>(smem + lay.thr);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;  // 32 query rows each
  const int warp_n = warp % 4;  // 32 corpus rows each
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  float* cv = reinterpret_cast<float*>(smem + lay.cv) + warp * BN;
  int* ci = reinterpret_cast<int*>(smem + lay.ci) + warp * BN;
  float* sv = reinterpret_cast<float*>(smem + lay.sv) + warp * BN;
  int* si = reinterpret_cast<int*>(smem + lay.si) + warp * BN;

  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n_valid) r_end = n_valid;
  const int n_tiles = r_begin < r_end ? (int)((r_end - r_begin + BN - 1) / BN) : 0;
  const int kchunks = Dp / KC;
  const int total = n_tiles * kchunks;

  const int qvec = Dp / 8;
  for (int idx = tid; idx < BQ * qvec; idx += THREADS) {
    int r = idx / qvec, col = (idx % qvec) * 8;
    bool ok = (q0 + r < Q) && (col < D);
    const __nv_bfloat16* src = ok ? q + (size_t)(q0 + r) * D + col : q;
    cp_async16(q_s + r * qld + col, src, ok);
  }
  // the lists of this CTA's queries start as k sentinels
  for (int idx = tid; idx < BQ * k; idx += THREADS) {
    int r = idx / k;
    if (q0 + r < Q) {
      size_t o = ((size_t)split * Q + q0 + r) * k + idx % k;
      list_v[o] = -INFINITY;
      list_i[o] = INT_MAX;
    }
  }
  if (tid < BQ) thr_s[tid] = -INFINITY;

  auto load_stage = [&](int step) {
    const int tile = step / kchunks, kc = step % kchunks;
    const long long r0 = r_begin + (long long)tile * BN;
    __nv_bfloat16* dst = c_s + (step & 1) * BN * CPAD;
    for (int idx = tid; idx < BN * KC / 8; idx += THREADS) {
      int r = idx / (KC / 8), col8 = (idx % (KC / 8)) * 8;
      long long grow = r0 + r;
      int col = kc * KC + col8;
      bool ok = grow < r_end && col < D;
      const __nv_bfloat16* src = ok ? c + (size_t)grow * D + col : c;
      cp_async16(dst + r * CPAD + col8, src, ok);
    }
  };

  // merge this tile's survivors of query qq into its list (one warp)
  auto merge_query = [&](int qq, long long r0) {
    const float thr = thr_s[qq];
    const float* row = s_s + qq * SPAD;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int col = lane + 32 * j;
      const float v = row[col];
      const bool take = r0 + col < r_end && v > thr;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) {
        int p = cnt + __popc(m & ((1u << lane) - 1u));
        cv[p] = v;
        ci[p] = (int)(r0 + col);
      }
      cnt += __popc(m);
    }
    if (cnt == 0) return;
    __syncwarp();
    // rank of each survivor among the survivors: (value desc, row asc);
    // buffer order is row order
    for (int t = lane; t < cnt; t += 32) {
      const float v = cv[t];
      int rank = 0;
      for (int u = 0; u < cnt; ++u) {
        const float w = cv[u];
        rank += (w > v) || (w == v && u < t);
      }
      sv[rank] = v;
      si[rank] = ci[t];
    }
    __syncwarp();
    float* Lv = list_v + ((size_t)split * Q + q0 + qq) * k;
    int* Li = list_i + ((size_t)split * Q + q0 + qq) * k;
    // new slots of the survivors (list entries are lower rows: they win ties)
    int pos[BN / 32];
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int t = lane + 32 * j;
      pos[j] = t < cnt ? t + count_ge(Lv, k, sv[t]) : k;
    }
    const int p0 = count_ge(Lv, k, sv[0]);  // first list entry that moves
    __syncwarp();
    for (int base = k - 1; base >= p0; base -= 32) {
      const int i = base - lane;
      float lv = 0.f;
      int li = 0, dst = k;
      if (i >= p0) {
        lv = Lv[i];
        li = Li[i];
        dst = i + count_gt(sv, cnt, lv);
      }
      __syncwarp();
      if (dst < k) {
        Lv[dst] = lv;
        Li[dst] = li;
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int t = lane + 32 * j;
      if (pos[j] < k) {
        Lv[pos[j]] = sv[t];
        Li[pos[j]] = si[t];
      }
    }
    __syncwarp();
    if (lane == 0) thr_s[qq] = Lv[k - 1];
    __syncwarp();
  };

  __syncthreads();  // sentinels and thresholds written before any merge
  if (total > 0) load_stage(0);
  cp_async_commit();  // group 0: query tile + first corpus chunk

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int step = 0; step < total; ++step) {
    const int tile = step / kchunks, kc = step % kchunks;
    if (step + 1 < total) {
      load_stage(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
    const __nv_bfloat16* cst = c_s + (step & 1) * BN * CPAD;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], q_s + (warp_m * 32 + i * 16) * qld + kc * KC + kk * 16, qld);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], cst + (warp_n * 32 + j * 16) * CPAD + kk * 16, CPAD);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kc == kchunks - 1) {
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(s_s + (warp_m * 32 + i * 16) * SPAD + warp_n * 32 + j * 16,
                                  acc[i][j], SPAD, wmma::mem_row_major);
      __syncthreads();
      const long long r0 = r_begin + (long long)tile * BN;
      for (int qq = warp; qq < BQ && q0 + qq < Q; qq += WARPS) merge_query(qq, r0);
    }
    __syncthreads();  // the stage and score tile are rewritten next step
  }
  cp_async_wait<0>();
}

// Merge the per-split lists of one query: k rounds, each taking the best
// head over the splits by (value desc, row asc). Sentinels (fewer than k
// rows in all) become (-1e30, 0).
constexpr int MERGE_THREADS = 128;

__global__ void __launch_bounds__(MERGE_THREADS)
topk_fused_merge(const float* __restrict__ list_v, const int* __restrict__ list_i,
                 float* __restrict__ out_v, int* __restrict__ out_i, int Q, int k,
                 int n_splits) {
  extern __shared__ int heads[];
  __shared__ float wv[MERGE_THREADS / 32];
  __shared__ int wi[MERGE_THREADS / 32], ws[MERGE_THREADS / 32];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int s = tid; s < n_splits; s += MERGE_THREADS) heads[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX, bs = -1;
    for (int s = tid; s < n_splits; s += MERGE_THREADS) {
      int h = heads[s];
      if (h >= k) continue;
      size_t o = ((size_t)s * Q + qi) * k + h;
      float v = list_v[o];
      int id = list_i[o];
      if (v > bv || (v == bv && id < bi)) { bv = v; bi = id; bs = s; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float v = __shfl_xor_sync(0xffffffffu, bv, off);
      int id = __shfl_xor_sync(0xffffffffu, bi, off);
      int s = __shfl_xor_sync(0xffffffffu, bs, off);
      if (v > bv || (v == bv && id < bi)) { bv = v; bi = id; bs = s; }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; ws[warp] = bs; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
        if (wv[w] > bv || (wv[w] == bv && wi[w] < bi)) { bv = wv[w]; bi = wi[w]; bs = ws[w]; }
      size_t o = (size_t)qi * k + j;
      if (bv == -INFINITY) {
        out_v[o] = NEG_INF;
        out_i[o] = 0;
      } else {
        out_v[o] = bv;
        out_i[o] = bi;
        heads[bs] += 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int topk_fused(const void* q, const void* c, void* list_v, void* list_i, void* out_v,
                          void* out_i, int Q, int n_valid, int D, int k, int n_splits,
                          void* stream) {
  if (Q <= 0 || n_valid < 0 || D <= 0 || D % 8 || k <= 0 || k > MAX_K || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dp = (D + KC - 1) / KC * KC;
  Layout lay(Dp);
  cudaError_t err = cudaFuncSetAttribute(topk_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = ((long long)n_valid + BN - 1) / BN;
  const long long rows_per_split = (n_tiles + n_splits - 1) / n_splits * BN;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  topk_fused_kernel<<<grid, THREADS, lay.total, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(list_v), static_cast<int*>(list_i), Q, n_valid, D, k, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_fused_merge<<<Q, MERGE_THREADS, sizeof(int) * n_splits, st>>>(
      static_cast<const float*>(list_v), static_cast<const int*>(list_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k, n_splits);
  return (int)cudaGetLastError();
}
