// Pass A of the exact two-pass top-k: per query, the top-k_sel corpus
// segments by maximum score, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/topk.py::_segtopk_kernel (the Pallas TPU
// kernel launched by topk_scores_twopass), its int8 mode (pass_a_int8=True,
// topk.py:355-379) and _segtopk_kernel_overlap (mxu_overlap=True).
//
// What it computes. Queries q (Q, D) and corpus c (N, D), row-major, either
// both bf16 (f32 accumulation) or both int8 (int32 accumulation). Segment s
// is the natural rows [s*L2, (s+1)*L2); segments with id < n_valid_segs are
// ranked by max_r q.c_r, rows at or past n scoring 0 (the JAX kernel's zero
// pad rows). In int8 mode the segment maximum is taken in int32 and only the
// maximum converts to f32 (exact below 2^24, i.e. for D < 1040). Output per
// query: the top-k_sel (value, segment id), ordered by value descending then
// id ascending -- the order of the TPU kernel's k-pass selection. Slots past
// the real segments hold value -1e30 and id -1-j.
//
// Three schedules of one kernel (template parameters):
//  * bf16, the default;
//  * bf16 overlap: the score tile is double-buffered in shared memory and the
//    segment reduction of tile t runs after the MMAs of tile t+1's first K
//    chunk are issued -- the Hopper form of the TPU kernel's "matmul slice
//    h+1 under the max of slice h". Same maxima, same insertion order, so
//    bit-identical results to the default;
//  * int8: int8 x int8 -> int32 WMMA (m16n16k16), twice the bf16 tensor-core
//    rate and half the corpus bytes.
//
// What bounds it on this card. 2*Q*N*D multiply-adds against an (N, D)
// corpus read: at the serve and bench shapes (Q in the thousands, D = 384)
// that is hundreds of operations per corpus byte, far above the H100's
// ~295 bf16 FLOP/byte ridge, so it is bound by tensor-core throughput.
//
// What the design does about it.
//  * The score tile is computed with tensor cores (WMMA, 16x16x16 fragments)
//    and reduced to segment maxima in shared memory at once: no score ever
//    reaches device memory, only (Q, k_sel) survives.
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
//  * bf16 tiles are row-major with a 16-byte row pad (no bank conflicts);
//    int8 tiles are stored K-step-major (16-byte rows per 16-wide K step),
//    so every int8 WMMA fragment starts on the 32-byte boundary it needs.
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
constexpr int KS = 16;        // K of one WMMA step
constexpr int THREADS = 256;  // 8 warps: 2 (query) x 4 (corpus)
constexpr int SPAD = BN + 4;  // row stride of the score tile (4-byte elements)
constexpr float NEG_INF = -1e30f;

// Operand traits: element type, accumulator, elements per 16-byte copy, and
// the shared-memory tile layout.
template <typename T>
struct Op;
template <>
struct Op<__nv_bfloat16> {
  using Acc = float;
  static constexpr int VEC = 8;
  static constexpr bool KMAJOR = false;
  __device__ static Acc max(Acc a, Acc b) { return fmaxf(a, b); }
};
template <>
struct Op<signed char> {
  using Acc = int;
  static constexpr int VEC = 16;
  static constexpr bool KMAJOR = true;
  __device__ static Acc max(Acc a, Acc b) { return a > b ? a : b; }
};

// Element offset of (row, col) in a shared tile of `rows` rows: row-major
// with row stride `ld`, or K-step-major (KS-wide, 16-byte rows).
template <typename T>
__device__ inline int tile_off(int row, int col, int rows, int ld) {
  if (Op<T>::KMAJOR) return ((col / KS) * rows + row) * KS + col % KS;
  return row * ld + col;
}
template <typename T>
__host__ __device__ inline int tile_ld(int width) {
  return Op<T>::KMAJOR ? KS : width + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ inline size_t tile_elems(int rows, int width) {
  return Op<T>::KMAJOR ? (size_t)rows * width : (size_t)rows * (width + 16 / sizeof(T));
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <typename T, bool OVERLAP>
struct Layout {
  size_t q, c, s, m, run, lv, li, total;
  __host__ __device__ Layout(int Dp, int nseg_tile, int k_sel) {
    q = 0;
    c = align128(q + sizeof(T) * tile_elems<T>(BQ, Dp));
    s = align128(c + sizeof(T) * 2 * tile_elems<T>(BN, KC));
    m = align128(s + 4 * (OVERLAP ? 2 : 1) * BQ * SPAD);
    run = align128(m + 4 * BQ * nseg_tile);
    lv = align128(run + 4 * BQ);
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

template <typename T, bool OVERLAP>
__global__ void __launch_bounds__(THREADS)
segtopk_kernel(const T* __restrict__ q, const T* __restrict__ c, float* __restrict__ part_v,
               int* __restrict__ part_i, int Q, int n, int D, int L2, int n_valid_segs, int k_sel,
               long long rows_per_split) {
  using Acc = typename Op<T>::Acc;
  constexpr int VEC = Op<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = (D + KC - 1) / KC * KC;
  const int qld = tile_ld<T>(Dp), cld = tile_ld<T>(KC);
  const int seg_t = L2 < BN ? L2 : BN;  // rows of one segment inside a tile
  const int nseg_tile = BN / seg_t;
  Layout<T, OVERLAP> lay(Dp, nseg_tile, k_sel);
  T* q_s = reinterpret_cast<T*>(smem + lay.q);
  T* c_s = reinterpret_cast<T*>(smem + lay.c);
  Acc* s_s = reinterpret_cast<Acc*>(smem + lay.s);
  Acc* m_s = reinterpret_cast<Acc*>(smem + lay.m);
  Acc* run_s = reinterpret_cast<Acc*>(smem + lay.run);
  float* lv_s = reinterpret_cast<float*>(smem + lay.lv);
  int* li_s = reinterpret_cast<int*>(smem + lay.li);
  const size_t stage_elems = tile_elems<T>(BN, KC);

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
  const int qvec = Dp / VEC;
  for (int idx = tid; idx < BQ * qvec; idx += THREADS) {
    int r = idx / qvec, col = (idx % qvec) * VEC;
    bool ok = (q0 + r < Q) && (col < D);
    const T* src = ok ? q + (size_t)(q0 + r) * D + col : q;
    cp_async16(q_s + tile_off<T>(r, col, BQ, qld), src, ok);
  }
  for (int idx = tid; idx < BQ * k_sel; idx += THREADS) {
    lv_s[idx] = -INFINITY;
    li_s[idx] = INT_MAX;
  }

  auto load_stage = [&](int step) {
    const int tile = step / kchunks, kc = step % kchunks;
    const long long r0 = r_begin + (long long)tile * BN;
    T* dst = c_s + (step & 1) * stage_elems;
    for (int idx = tid; idx < BN * KC / VEC; idx += THREADS) {
      int r = idx / (KC / VEC), col8 = (idx % (KC / VEC)) * VEC;
      long long grow = r0 + r;
      int col = kc * KC + col8;
      bool ok = grow < n && col < D;
      const T* src = ok ? c + (size_t)grow * D + col : c;
      cp_async16(dst + tile_off<T>(r, col8, BN, cld), src, ok);
    }
  };

  // score tile of `tile` (in buffer `buf`) -> segment maxima -> lists
  auto reduce_tile = [&](int tile, int buf) {
    const Acc* st = s_s + buf * BQ * SPAD;
    const long long r0 = r_begin + (long long)tile * BN;
    if (L2 <= BN) {
      for (int idx = tid; idx < BQ * nseg_tile; idx += THREADS) {
        int r = idx % BQ, s = idx / BQ;
        const Acc* row = st + r * SPAD + s * seg_t;
        Acc m = row[0];
        for (int j = 1; j < seg_t; ++j) m = Op<T>::max(m, row[j]);
        m_s[s * BQ + r] = m;
      }
      __syncthreads();
      if (tid < BQ) {
        const int seg0 = (int)(r0 / L2);
        for (int s = 0; s < nseg_tile; ++s) {
          if (seg0 + s >= n_valid_segs) break;
          list_insert(lv_s + tid * k_sel, li_s + tid * k_sel, k_sel, (float)m_s[s * BQ + tid],
                      seg0 + s);
        }
      }
    } else {
      // a segment spans L2/BN whole tiles: fold this tile into the running
      // maximum of its segment; insert once its last tile is done
      const int r = tid / 4, part = tid % 4;
      const Acc* row = st + r * SPAD + part * (BN / 4);
      Acc m = row[0];
      for (int j = 1; j < BN / 4; ++j) m = Op<T>::max(m, row[j]);
      m = Op<T>::max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = Op<T>::max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (part == 0) {
        Acc run = (r0 % L2 == 0) ? m : Op<T>::max(run_s[r], m);
        run_s[r] = run;
        if ((r0 + BN) % L2 == 0)
          list_insert(lv_s + r * k_sel, li_s + r * k_sel, k_sel, (float)run, (int)(r0 / L2));
      }
    }
  };

  if (total > 0) load_stage(0);
  cp_async_commit();  // group 0: query tile + first corpus chunk

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][2];
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
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);
    }
    const T* cst = c_s + (step & 1) * stage_elems;
#pragma unroll
    for (int kk = 0; kk < KC / KS; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], q_s + tile_off<T>(warp_m * 32 + i * 16, kc * KC + kk * KS, BQ, qld), qld);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], cst + tile_off<T>(warp_n * 32 + j * 16, kk * KS, BN, cld),
                               cld);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }

    // overlap: tile-1's reduction runs after this tile's first MMAs issued
    if (OVERLAP && kc == 0 && tile > 0) reduce_tile(tile - 1, (tile - 1) & 1);
    if (kc == kchunks - 1) {
      const int buf = OVERLAP ? (tile & 1) : 0;
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(
              s_s + buf * BQ * SPAD + (warp_m * 32 + i * 16) * SPAD + warp_n * 32 + j * 16,
              acc[i][j], SPAD, wmma::mem_row_major);
      if (!OVERLAP) {
        __syncthreads();
        reduce_tile(tile, 0);
      }
    }
    __syncthreads();  // the stage and score tile are rewritten next step
  }
  cp_async_wait<0>();
  __syncthreads();
  if (OVERLAP && n_tiles > 0) {
    reduce_tile(n_tiles - 1, (n_tiles - 1) & 1);
    __syncthreads();
  }

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

template <typename T, bool OVERLAP>
int launch(const void* q, const void* c, void* part_v, void* part_i, void* out_v, void* out_i,
           int Q, int n, int D, int L2, int n_valid_segs, int k_sel, int n_splits,
           cudaStream_t st) {
  if (D % Op<T>::VEC) return (int)cudaErrorInvalidValue;
  const int Dp = (D + KC - 1) / KC * KC;
  const int seg_t = L2 < BN ? L2 : BN;
  Layout<T, OVERLAP> lay(Dp, BN / seg_t, k_sel);
  cudaError_t err = cudaFuncSetAttribute(segtopk_kernel<T, OVERLAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long unit = L2 > BN ? L2 : BN;  // split ranges end on segment boundaries
  const long long n_units = ((long long)n_valid_segs * L2 + unit - 1) / unit;
  const long long units_per_split = (n_units + n_splits - 1) / n_splits;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  segtopk_kernel<T, OVERLAP><<<grid, THREADS, lay.total, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), static_cast<float*>(part_v),
      static_cast<int*>(part_i), Q, n, D, L2, n_valid_segs, k_sel, units_per_split * unit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segtopk_merge<<<Q, MERGE_THREADS, sizeof(int) * n_splits, st>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k_sel, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: bf16; mode 1: bf16, overlap schedule; mode 2: int8.
extern "C" int segtopk_pass_a(const void* q, const void* c, void* part_v, void* part_i,
                              void* out_v, void* out_i, int Q, int n, int D, int L2,
                              int n_valid_segs, int k_sel, int n_splits, int mode, void* stream) {
  if (Q <= 0 || n <= 0 || D <= 0 || L2 <= 0 || k_sel <= 0 || k_sel > 128 || n_splits <= 0 ||
      (BN % L2 != 0 && L2 % BN != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<__nv_bfloat16, false>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                          n_valid_segs, k_sel, n_splits, st);
    case 1:
      return launch<__nv_bfloat16, true>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                         n_valid_segs, k_sel, n_splits, st);
    case 2:
      return launch<signed char, false>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                        n_valid_segs, k_sel, n_splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
