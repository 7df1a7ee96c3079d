// Pass A of the exact two-pass top-k: per query, the top-k_sel corpus
// segments by maximum score, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/topk.py::_segtopk_kernel (the Pallas TPU
// kernel launched by topk_scores_twopass).
//
// What it computes. Queries q (Q, D) and corpus c (N, D), both bf16 and
// row-major. Segment s is the natural rows [s*L2, (s+1)*L2); segments with
// id < n_valid_segs are ranked by max_r q.c_r (f32 accumulation), rows at or
// past n scoring 0 (the JAX kernel's zero pad rows). Output per query: the
// top-k_sel (value, segment id), ordered by value descending then id
// ascending -- the order of the TPU kernel's k-pass selection. Slots past the
// real segments hold value -1e30 and id -1-j.
//
// What bounds it on this card. 2*Q*N*D multiply-adds against an (N, D)
// corpus read: at the serve and bench shapes (Q in the thousands, D = 384)
// that is hundreds of operations per corpus byte, far above the H100's
// ~295 bf16 FLOP/byte ridge, so it is bound by tensor-core throughput.
//
// What the design does about it.
//  * The score tile is computed with tensor cores (WMMA bf16 16x16x16, f32
//    accumulators) and reduced to segment maxima in shared memory at once:
//    no score ever reaches device memory, only (Q, k_sel) survives.
//  * The TPU grid ran in order and carried a running top-k from one corpus
//    block to the next; CUDA blocks run in parallel in no order. So the grid
//    is (query tiles of 64) x (corpus splits): each CTA scans a contiguous,
//    segment-aligned corpus range in tiles of 128 rows, keeps its own
//    per-query top-k_sel list in shared memory, and writes it out; a second
//    small kernel merges the splits per query. Splits are chosen by the
//    caller so the grid fills the 132 SMs even for a small query batch.
//  * The query tile stays resident in shared memory for the whole scan; the
//    corpus tile streams in 64-wide K chunks through a two-stage cp.async
//    ring, so the next chunk's load overlaps this chunk's MMAs.
//  * A candidate enters a list only if it beats the list's last entry, so
//    after the first tiles almost every segment costs one compare.
// Not yet done (later work): wgmma, TMA, warp specialisation, a register
// epilogue that skips the shared-memory score tile.
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
constexpr int CPAD = KC + 8;  // bf16 row stride of a corpus stage
constexpr int SPAD = BN + 4;  // f32 row stride of the score tile
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Layout {
  size_t q, c, s, m, run, lv, li, total;
  __host__ __device__ Layout(int Dp, int nseg_tile, int k_sel) {
    q = 0;
    c = align128(q + sizeof(__nv_bfloat16) * BQ * (Dp + 8));
    s = align128(c + sizeof(__nv_bfloat16) * 2 * BN * CPAD);
    m = align128(s + sizeof(float) * BQ * SPAD);
    run = align128(m + sizeof(float) * BQ * nseg_tile);
    lv = align128(run + sizeof(float) * BQ);
    li = align128(lv + sizeof(float) * BQ * k_sel);
    total = align128(li + sizeof(int) * BQ * k_sel);
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

// Insert (v, id) into one query's list, sorted by value descending. Ids
// arrive in ascending order within a CTA, so an equal value goes after the
// entries already there and, at the boundary, is rejected.
__device__ inline void list_insert(float* lv, int* li, int k_sel, float v, int id) {
  if (!(v > lv[k_sel - 1])) return;
  int j = k_sel - 1;
  while (j > 0 && lv[j - 1] < v) {
    lv[j] = lv[j - 1];
    li[j] = li[j - 1];
    --j;
  }
  lv[j] = v;
  li[j] = id;
}

__global__ void __launch_bounds__(THREADS)
segtopk_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c,
               float* __restrict__ part_v, int* __restrict__ part_i, int Q, int n, int D,
               int L2, int n_valid_segs, int k_sel, long long rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = (D + KC - 1) / KC * KC;
  const int qld = Dp + 8;
  const int seg_t = L2 < BN ? L2 : BN;  // rows of one segment inside a tile
  const int nseg_tile = BN / seg_t;
  Layout lay(Dp, nseg_tile, k_sel);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.c);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* run_s = reinterpret_cast<float*>(smem + lay.run);
  float* lv_s = reinterpret_cast<float*>(smem + lay.lv);
  int* li_s = reinterpret_cast<int*>(smem + lay.li);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;  // 32 query rows each
  const int warp_n = warp % 4;  // 32 corpus rows each
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;

  const long long seg_end = (long long)n_valid_segs * L2;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > seg_end) r_end = seg_end;
  const int n_tiles = r_begin < r_end ? (int)((r_end - r_begin + BN - 1) / BN) : 0;
  const int kchunks = Dp / KC;
  const int total = n_tiles * kchunks;

  // resident query tile (zero rows past Q, zero columns past D)
  const int qvec = Dp / 8;
  for (int idx = tid; idx < BQ * qvec; idx += THREADS) {
    int r = idx / qvec, col = (idx % qvec) * 8;
    bool ok = (q0 + r < Q) && (col < D);
    const __nv_bfloat16* src = ok ? q + (size_t)(q0 + r) * D + col : q;
    cp_async16(q_s + r * qld + col, src, ok);
  }
  for (int idx = tid; idx < BQ * k_sel; idx += THREADS) {
    lv_s[idx] = -INFINITY;
    li_s[idx] = INT_MAX;
  }

  auto load_stage = [&](int step) {
    const int tile = step / kchunks, kc = step % kchunks;
    const long long r0 = r_begin + (long long)tile * BN;
    __nv_bfloat16* dst = c_s + (step & 1) * BN * CPAD;
    for (int idx = tid; idx < BN * KC / 8; idx += THREADS) {
      int r = idx / (KC / 8), col8 = (idx % (KC / 8)) * 8;
      long long grow = r0 + r;
      int col = kc * KC + col8;
      bool ok = grow < n && col < D;
      const __nv_bfloat16* src = ok ? c + (size_t)grow * D + col : c;
      cp_async16(dst + r * CPAD + col8, src, ok);
    }
  };

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
      // ---- epilogue: score tile -> segment maxima -> per-query lists ----
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(s_s + (warp_m * 32 + i * 16) * SPAD + warp_n * 32 + j * 16,
                                  acc[i][j], SPAD, wmma::mem_row_major);
      __syncthreads();
      const long long r0 = r_begin + (long long)tile * BN;
      if (L2 <= BN) {
        for (int idx = tid; idx < BQ * nseg_tile; idx += THREADS) {
          int r = idx % BQ, s = idx / BQ;
          const float* row = s_s + r * SPAD + s * seg_t;
          float m = row[0];
          for (int j = 1; j < seg_t; ++j) m = fmaxf(m, row[j]);
          m_s[s * BQ + r] = m;
        }
        __syncthreads();
        if (tid < BQ) {
          const int seg0 = (int)(r0 / L2);
          for (int s = 0; s < nseg_tile; ++s) {
            if (seg0 + s >= n_valid_segs) break;
            list_insert(lv_s + tid * k_sel, li_s + tid * k_sel, k_sel, m_s[s * BQ + tid], seg0 + s);
          }
        }
      } else {
        // a segment spans L2/BN whole tiles: fold this tile into the running
        // maximum of its segment; insert once its last tile is done
        const int r = tid / 4, part = tid % 4;
        const float* row = s_s + r * SPAD + part * (BN / 4);
        float m = row[0];
        for (int j = 1; j < BN / 4; ++j) m = fmaxf(m, row[j]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (part == 0) {
          float run = (r0 % L2 == 0) ? m : fmaxf(run_s[r], m);
          run_s[r] = run;
          if ((r0 + BN) % L2 == 0)
            list_insert(lv_s + r * k_sel, li_s + r * k_sel, k_sel, run, (int)(r0 / L2));
        }
      }
    }
    __syncthreads();  // the stage and score tile are rewritten next step
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int idx = tid; idx < BQ * k_sel; idx += THREADS) {
    int r = idx / k_sel;
    if (q0 + r < Q) {
      size_t o = ((size_t)split * Q + q0 + r) * k_sel + idx % k_sel;
      part_v[o] = lv_s[idx];
      part_i[o] = li_s[idx];
    }
  }
}

// Merge the per-split lists of one query: k_sel rounds, each taking the best
// head over the splits by (value desc, id asc). Splits cover disjoint
// segment ranges, so ids never tie.
constexpr int MERGE_THREADS = 128;

__global__ void __launch_bounds__(MERGE_THREADS)
segtopk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
              float* __restrict__ out_v, int* __restrict__ out_i, int Q, int k_sel,
              int n_splits) {
  extern __shared__ int heads[];
  __shared__ float wv[MERGE_THREADS / 32];
  __shared__ int wi[MERGE_THREADS / 32], ws[MERGE_THREADS / 32];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int s = tid; s < n_splits; s += MERGE_THREADS) heads[s] = 0;
  __syncthreads();
  for (int j = 0; j < k_sel; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX, bs = -1;
    for (int s = tid; s < n_splits; s += MERGE_THREADS) {
      int h = heads[s];
      if (h >= k_sel) continue;
      size_t o = ((size_t)s * Q + qi) * k_sel + h;
      float v = part_v[o];
      int id = part_i[o];
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
      size_t o = (size_t)qi * k_sel + j;
      if (bv == -INFINITY) {  // fewer real segments than k_sel
        out_v[o] = NEG_INF;
        out_i[o] = -1 - j;
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

extern "C" int segtopk_pass_a(const void* q, const void* c, void* part_v, void* part_i,
                              void* out_v, void* out_i, int Q, int n, int D, int L2,
                              int n_valid_segs, int k_sel, int n_splits, void* stream) {
  if (Q <= 0 || n <= 0 || D <= 0 || D % 8 || L2 <= 0 || k_sel <= 0 || k_sel > 128 ||
      n_splits <= 0 || (BN % L2 != 0 && L2 % BN != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dp = (D + KC - 1) / KC * KC;
  const int seg_t = L2 < BN ? L2 : BN;
  Layout lay(Dp, BN / seg_t, k_sel);
  cudaError_t err = cudaFuncSetAttribute(segtopk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long unit = L2 > BN ? L2 : BN;  // split ranges end on segment boundaries
  const long long n_units = ((long long)n_valid_segs * L2 + unit - 1) / unit;
  const long long units_per_split = (n_units + n_splits - 1) / n_splits;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  segtopk_kernel<<<grid, THREADS, lay.total, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
      static_cast<float*>(part_v), static_cast<int*>(part_i), Q, n, D, L2, n_valid_segs, k_sel,
      units_per_split * unit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segtopk_merge<<<Q, MERGE_THREADS, sizeof(int) * n_splits, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k_sel, n_splits);
  return (int)cudaGetLastError();
}
