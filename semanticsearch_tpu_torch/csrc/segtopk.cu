// Pass A of the exact two-pass top-k: per query, the top-k_sel corpus
// segments by maximum score, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/topk.py::_segtopk_kernel (the Pallas TPU
// kernel launched by topk_scores_twopass) on bf16 and f32 operands, its int8
// mode (pass_a_int8=True, topk.py:355-379) and _segtopk_kernel_overlap
// (mxu_overlap=True).
//
// What it computes. Queries q (Q, D) and corpus c (N, D), row-major, both
// bf16 (f32 accumulation), both int8 (int32 accumulation) or both f32. Segment
// s is the natural rows [s*L2, (s+1)*L2); segments with id < n_valid_segs are
// ranked by max_r q.c_r, rows at or past n scoring 0 (the JAX kernel's zero
// pad rows). In int8 mode the segment maximum is taken in int32 and only the
// maximum converts to f32 (exact below 2^24, i.e. for D < 1040). Output per
// query: the top-k_sel (value, segment id), ordered by value descending then
// id ascending -- the order of the TPU kernel's k-pass selection. Slots past
// the real segments hold value -1e30 and id -1-j.
//
// What bounds it on this card. 2*Q*N*D multiply-adds against an (N, D)
// corpus read: at the serve and bench shapes (Q in the thousands, D = 384)
// that is hundreds of operations per corpus byte, far above the H100's
// ~295 bf16 FLOP/byte ridge, so it is bound by tensor-core throughput; and,
// below that, by the bytes each CTA pulls from L2 per operation, which only
// the number of queries sharing a corpus tile lowers.
//
// The bf16 default (mode 0): what the design does about it.
//  * The main loop is qc_mainloop.cuh: a resident query tile of 128 rows (64
//    for a batch of at most 64 queries or a wide D), the corpus streamed by
//    TMA through an mbarrier ring, wgmma m64n128k16 by one consumer
//    warpgroup per 64 query rows, a producer warpgroup that gives its
//    registers to them. 128 queries share every corpus byte a CTA fetches.
//  * The epilogue works in the accumulator registers. A thread holds, for two
//    query rows, column pairs of every 8-column block; a segment of 8..128
//    columns is a maximum over the thread's own columns and two quad
//    shuffles, a segment longer than a tile carries its running maximum in a
//    register from tile to tile, and segments of 1, 2 or 4 rows are handed to
//    the inserting lane by shuffles. No score tile exists in shared or device
//    memory. One lane of the quad per query row compares each maximum with
//    the row's threshold (the value of the list's worst entry, kept in a
//    register), and a tile in which no score of a warp's 16 rows beats its
//    row's threshold is dropped after 64 maxima and one vote: after the
//    first tiles that is nearly every tile. A
//    survivor replaces the worst entry of the row's UNSORTED list in shared
//    memory and one scan finds the new worst; segments arrive in ascending
//    id, so `v > threshold` alone gives ties to the lower id. The lists are
//    ranked once, when the CTA writes them out.
//  * The TPU grid ran in order and carried a running top-k from block to
//    block; CUDA blocks run in parallel in no order. So the grid is (query
//    tiles) x (corpus splits): each CTA scans a contiguous, segment-aligned
//    corpus range, keeps its own per-query list, and writes it out; a second
//    small kernel merges the splits per query. The wrapper plans tile rows,
//    stages and splits (ops/topk.py::pass_a_plan) and passes them in.
//
// The overlap schedule (mode 1): the same kernel, the same multiplies in the
// same order and the same epilogue per query row, so its results equal mode
// 0's bit for bit; only the ring differs. At the shard shape the card runs
// at its power limit, and the tensor cores wait at every tile: on mode 0's
// ring of 4 stages (under one tile of 6 K chunks at D = 384) the two
// consumer warpgroups stay in step, finish a tile together and drain their
// wgmma groups at once. Mode 1 runs on the deepest ring that fits
// (ops/topk.py::overlap_plan: 7 stages at D = 384, more than a tile), so
// neither warpgroup waits on the other's stages: they drift up to a tile
// apart and one's drain and epilogue fall under the other's multiplies
// (a clock probe in the epilogues measured both). Barriers that hold them half a
// tile apart (FA3's warpgroup ordering) measured slower: each turns the
// other warpgroup's jitter into a stall. A CTA of 64 query rows has one
// consumer warpgroup and keeps mode 0's ring.
//
// The int8 schedule (mode 2): mode 0's kernel on int8 operands. A K chunk of
// 128 bytes is 128 int8 columns, each stage four wgmma m64n128k32 s8 x s8 ->
// s32, so a tile costs half the bytes and half the instructions of bf16 at
// the same D. The s32 accumulators lie in the f32 ones' layout, and the same
// register epilogue takes the segment maxima in int32 before it converts each
// to f32. TMA needs 16-byte row pitches: widths are multiples of 16 (the
// wrapper pads other widths with zero columns, which change no product).
// Tiles and stages come from ops/topk.py::pass_a_int8_plan.
//
// The f32 schedule (mode 3): mode 0's kernel and register epilogue on the
// 3xTF32 main loop of tf32_mainloop.cuh. Both f32 operands stream through
// the ring, a stage one 32-column K chunk of the query tile and of the
// corpus tile (48 KB at 128 query rows, whatever D); the consumers write the
// corpus box's TF32 lo plane beside it as it lands (the raw box is its hi
// plane, truncated by the tensor cores), split the query fragments in
// registers, and run three TF32 wgmma products per K step, the small
// terms in an accumulator of their own; the two sums meet once per tile in
// the f32 layout the epilogue reads. Values are within about 2^-21 |q| |c|
// of the plain f32 product (inside the D * 2^-24 an f32 index may differ
// by), and equal to it bit for bit on integer-valued rows. What bounds it:
// three TF32 products per score at 495 TFLOP/s, and the query tile read
// again from L2 for every corpus tile. TMA needs 16-byte row pitches: f32
// widths are multiples of 4 (the wrapper pads others with zero columns).
// Tiles and stages come from ops/topk.py::pass_a_f32_plan.
//
// The wide schedule (mode 4): mode 0's kernel and register epilogue on bf16
// operands wider than the resident query tile allows
// (ops/topk.py::pass_a_max_d: 1,536 columns at k_sel 1, 1,024 at 128; a
// 2,048-wide LLM embedder's rows do not fit). qs_mainloop.cuh streams the
// query tile's K chunks through the ring beside the corpus tile's, as the
// f32 schedule does, so the shared memory does not grow with D; the same
// wgmma products in the same order and the same epilogue give mode 0's
// selections and ties. What bounds it: at the LFM2 cell's shape (256
// queries, 10M x 2,048) the corpus read, 41 GB, with the query tile read
// again from L2 for every corpus tile. The wrapper takes it only past
// pass_a_max_d, so narrower rows keep mode 0. Tiles and stages come from
// ops/topk.py::pass_a_wide_plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "qc_mainloop.cuh"
#include "qs_mainloop.cuh"
#include "tf32_mainloop.cuh"

namespace {

constexpr int BN = qc::BN;  // corpus rows per tile
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------ the wgmma kernel

// row stride of the lists, in entries: odd, so the 16 inserting lanes of a
// warp (16 rows, the same slot) fall on different banks
__host__ __device__ inline int list_stride(int k_sel) { return k_sel | 1; }

// bytes of shared memory of the wgmma kernel: the main loop's
// (qc_mainloop.cuh's for bf16 and int8, qs_mainloop.cuh's for the wide
// schedule, tf32_mainloop.cuh's for f32), then the lists (per query row
// list_stride(k_sel) values and as many ids)
template <typename Op>
inline size_t wg_smem_bytes(int bq, int D, int n_stages, int k_sel) {
  const size_t lists = (size_t)bq * list_stride(k_sel) * 8;
  if constexpr (std::is_same<Op, qs::Bf16StreamOp>::value)
    return qs::mainloop_bytes(bq, n_stages) + lists;
  else
    return tf32q::mainloop_bytes_of<Op>(bq, D, n_stages) + lists;
}

// the epilogue's maxima in the accumulators' own type: fmaxf for f32, max
// for s32 (whose maxima convert to f32 only once a segment is complete)
__device__ __forceinline__ float acc_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int acc_max(int a, int b) { return max(a, b); }
template <typename Acc>
__device__ __forceinline__ Acc acc_lowest();
template <>
__device__ __forceinline__ float acc_lowest<float>() { return -INFINITY; }
template <>
__device__ __forceinline__ int acc_lowest<int>() { return INT_MIN; }

// true where entry (v, id) ranks below entry (w, jd): lower value, or the
// same value and a higher id
__device__ __forceinline__ bool ranks_below(float v, int id, float w, int jd) {
  return v < w || (v == w && id > jd);
}

// Replace the list's worst entry, at *worst, by (v, id), v known to beat it;
// find the new worst and return its value. The list is NOT kept sorted: an
// accepted segment costs k_sel independent reads instead of a dependent
// shift of half the list, and the rows are ranked once, on the way out.
__device__ __noinline__ float list_replace(float* lv, int* li, int k_sel, int* worst, float v,
                                           int id) {
  lv[*worst] = v;
  li[*worst] = id;
  float wv = lv[0];
  int wi = li[0], wp = 0;
  for (int j = 1; j < k_sel; ++j) {
    const float x = lv[j];
    const int xi = li[j];
    if (ranks_below(x, xi, wv, wi)) {
      wv = x;
      wi = xi;
      wp = j;
    }
  }
  *worst = wp;
  return wv;
}

template <typename Op, int NWG>
__global__ void __launch_bounds__((NWG + 1) * qc::WG_THREADS, 1)
segtopk_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap cmap, float* __restrict__ part_v,
                     int* __restrict__ part_i, int Q, int D, int L2, int n_valid_segs, int k_sel,
                     long long rows_per_split, int n_stages) {
  using Acc = typename Op::Acc;
  constexpr int BQW = NWG * 64;
  constexpr int ELEM = sizeof(typename Op::Elem);
  constexpr bool F32 = std::is_same<Op, tf32q::F32Op>::value;  // the 3xTF32 main loop
  constexpr bool QS = std::is_same<Op, qs::Bf16StreamOp>::value;  // the wide schedule
  extern __shared__ unsigned char smem_raw[];
  const int rb = qc::row_bytes(D, ELEM);
  const int kchunks = rb / qc::CHUNK_BYTES;
  qc::Ring ring;
  tf32q::Ring ring32;
  qs::Ring ring_qs;
  unsigned char* own;
  if constexpr (F32)
    own = tf32q::ring_setup(ring32, smem_raw, BQW, n_stages, NWG * 4);
  else if constexpr (QS)
    own = qs::ring_setup(ring_qs, smem_raw, BQW, n_stages, NWG * 4);
  else
    own = qc::ring_setup(ring, smem_raw, BQW, rb, n_stages, NWG * 4);
  const int ls = list_stride(k_sel);
  float* lv_s = reinterpret_cast<float*>(own);
  int* li_s = reinterpret_cast<int*>(own + (size_t)BQW * ls * 4);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQW;
  const int split = blockIdx.y;
  const long long seg_end = (long long)n_valid_segs * L2;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > seg_end) r_end = seg_end;
  const int n_tiles = r_begin < r_end ? (int)((r_end - r_begin + BN - 1) / BN) : 0;

  // every slot starts as the worst possible entry; slot j's id INT_MAX - j
  // keeps the empty slots distinct, the last one the worst
  for (int idx = tid; idx < BQW * ls; idx += (NWG + 1) * qc::WG_THREADS) {
    lv_s[idx] = -INFINITY;
    li_s[idx] = idx % ls < k_sel ? INT_MAX - (k_sel - 1 - idx % ls) : INT_MAX;
  }
  __syncthreads();

  if (tid >= NWG * qc::WG_THREADS) {
    // ------------------------------------------------ producer warpgroup
    if (NWG == 2) qc::reg_dealloc<40>();
    if (tid == NWG * qc::WG_THREADS) {
      if constexpr (F32)
        tf32q::produce(ring32, &qmap, &cmap, q0, kchunks, r_begin, n_tiles);
      else if constexpr (QS)
        qs::produce(ring_qs, &qmap, &cmap, q0, kchunks, r_begin, n_tiles);
      else
        qc::produce(ring, &qmap, &cmap, BQW, q0, kchunks, qc::CHUNK_BYTES / ELEM, r_begin,
                    n_tiles);
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    if (NWG == 2) qc::reg_alloc<232>();
    const int wg = tid / qc::WG_THREADS;
    const int warp = (tid / 32) & 3;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int quad_base = lane & ~3;
    // lane 0 of a quad inserts for the quad's upper row, lane 1 for the row
    // eight below
    const int my_row = wg * 64 + warp * 16 + (lane >> 2) + (quad == 1 ? 8 : 0);
    const bool inserter = quad < 2 && q0 + my_row < Q;
    float* my_lv = lv_s + my_row * ls;
    int* my_li = li_s + my_row * ls;
    // the value of the list's worst entry; a row past Q takes nothing
    float thr = inserter ? -INFINITY : INFINITY;
    int worst = k_sel - 1;  // and its slot
    float run = -INFINITY;  // running maximum of a segment longer than a tile
    const int seg_t = L2 < BN ? L2 : BN;
    const int bps = seg_t >= 8 ? seg_t / 8 : 1;  // 8-column blocks per segment

    auto offer = [&](float v, int seg) {
      // ids ascend, so a segment that only ties the worst entry loses to it
      if (inserter && seg < n_valid_segs && v > thr)
        thr = list_replace(my_lv, my_li, k_sel, &worst, v, seg);
    };

    auto epilogue = [&](int tile, Acc (&acc)[64]) {
      const long long r0 = r_begin + (long long)tile * BN;
      if (L2 <= BN) {
        // nothing in the tile beats a threshold of this warp's 16 rows (the
        // common case after the first tiles): 64 maxima and one vote
        const float thr_a = __shfl_sync(0xffffffffu, thr, quad_base);
        const float thr_b = __shfl_sync(0xffffffffu, thr, quad_base + 1);
        Acc m_a = acc_lowest<Acc>(), m_b = acc_lowest<Acc>();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m_a = acc_max(m_a, acc_max(acc[4 * j], acc[4 * j + 1]));
          m_b = acc_max(m_b, acc_max(acc[4 * j + 2], acc[4 * j + 3]));
        }
        if (!__any_sync(0xffffffffu, (float)m_a > thr_a || (float)m_b > thr_b)) return;
      }
      if (seg_t >= 8) {
        const int seg0 = (int)(r0 / L2);
        Acc m0 = acc_lowest<Acc>(), m1 = acc_lowest<Acc>();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m0 = acc_max(m0, acc_max(acc[4 * j], acc[4 * j + 1]));
          m1 = acc_max(m1, acc_max(acc[4 * j + 2], acc[4 * j + 3]));
          if (((j + 1) & (bps - 1)) == 0) {  // a segment (or the tile) ends here
            m0 = acc_max(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
            m1 = acc_max(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
            m0 = acc_max(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
            m1 = acc_max(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
            const float mine = (float)(quad == 1 ? m1 : m0);
            if (L2 <= BN) {
              offer(mine, seg0 + j / bps);
            } else {
              run = (r0 % L2 == 0) ? mine : fmaxf(run, mine);
              if ((r0 + BN) % L2 == 0) offer(run, seg0);
            }
            m0 = m1 = acc_lowest<Acc>();
          }
        }
      } else {
        // segments of 1, 2 or 4 rows: several per 8-column block, spread
        // over the quad; each lane's part goes to the inserting lane in
        // ascending segment id
        const int seg0 = (int)(r0 / seg_t);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const Acc a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
            const bool mine = quad == h;
            if (seg_t == 1) {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const float va = (float)__shfl_sync(0xffffffffu, a, quad_base + t);
                const float vb = (float)__shfl_sync(0xffffffffu, b, quad_base + t);
                if (mine) {
                  offer(va, seg0 + 8 * j + 2 * t);
                  offer(vb, seg0 + 8 * j + 2 * t + 1);
                }
              }
            } else if (seg_t == 2) {
              const Acc m = acc_max(a, b);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const float v = (float)__shfl_sync(0xffffffffu, m, quad_base + t);
                if (mine) offer(v, seg0 + 4 * j + t);
              }
            } else {
              Acc m = acc_max(a, b);
              m = acc_max(m, __shfl_xor_sync(0xffffffffu, m, 1));
#pragma unroll
              for (int t = 0; t < 4; t += 2) {
                const float v = (float)__shfl_sync(0xffffffffu, m, quad_base + t);
                if (mine) offer(v, seg0 + 2 * j + t / 2);
              }
            }
          }
        }
      }
    };
    if constexpr (F32)
      tf32q::consume<NWG>(ring32, kchunks, n_tiles, epilogue);
    else if constexpr (QS)
      qs::consume<Op>(ring_qs, wg, kchunks, n_tiles, epilogue);
    else
      qc::consume<Op>(ring, wg, BQW, kchunks, n_tiles, epilogue);

    // each warp owns its 16 rows' lists and writes them out itself, every
    // entry at its rank by (value desc, id asc); empty slots rank last, in
    // slot order, as (-inf, INT_MAX)
    __syncwarp();
    const int row0 = wg * 64 + warp * 16;
    for (int idx = lane; idx < 16 * k_sel; idx += 32) {
      const int r = row0 + idx / k_sel;
      if (q0 + r >= Q) continue;
      const float* lv = lv_s + r * ls;
      const int* li = li_s + r * ls;
      const float v = lv[idx % k_sel];
      const int id = li[idx % k_sel];
      int rank = 0;
      for (int j = 0; j < k_sel; ++j) rank += ranks_below(v, id, lv[j], li[j]);
      const size_t o = ((size_t)split * Q + q0 + r) * k_sel + rank;
      part_v[o] = v;
      part_i[o] = v == -INFINITY ? INT_MAX : id;
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

// The same merge for at most MERGE_THREADS splits: thread s keeps split s's
// head and the entry after it in registers, so a round is one reduction and
// the winner's reload runs under the next round instead of in front of it.
__global__ void __launch_bounds__(MERGE_THREADS)
segtopk_merge_few(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  float* __restrict__ out_v, int* __restrict__ out_i, int Q, int k_sel,
                  int n_splits) {
  __shared__ float wv[2][MERGE_THREADS / 32];
  __shared__ int wi[2][MERGE_THREADS / 32], ws[2][MERGE_THREADS / 32];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool have = tid < n_splits;
  const float* pv = part_v + ((size_t)(have ? tid : 0) * Q + qi) * k_sel;
  const int* pi = part_i + ((size_t)(have ? tid : 0) * Q + qi) * k_sel;
  int h = 0;
  float cv = have ? pv[0] : -INFINITY, nv = have && k_sel > 1 ? pv[1] : -INFINITY;
  int ci = have ? pi[0] : INT_MAX, ni = have && k_sel > 1 ? pi[1] : INT_MAX;
  for (int j = 0; j < k_sel; ++j) {
    float bv = cv;
    int bi = ci, bs = tid;
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, off);
      const int id = __shfl_xor_sync(0xffffffffu, bi, off);
      const int sp = __shfl_xor_sync(0xffffffffu, bs, off);
      if (v > bv || (v == bv && id < bi)) { bv = v; bi = id; bs = sp; }
    }
    const int buf = j & 1;
    if (lane == 0) { wv[buf][warp] = bv; wi[buf][warp] = bi; ws[buf][warp] = bs; }
    __syncthreads();
    bv = wv[buf][0]; bi = wi[buf][0]; bs = ws[buf][0];
    for (int w = 1; w < MERGE_THREADS / 32; ++w)
      if (wv[buf][w] > bv || (wv[buf][w] == bv && wi[buf][w] < bi)) {
        bv = wv[buf][w]; bi = wi[buf][w]; bs = ws[buf][w];
      }
    if (tid == 0) {
      const size_t o = (size_t)qi * k_sel + j;
      out_v[o] = bv == -INFINITY ? NEG_INF : bv;  // fewer real segments than k_sel
      out_i[o] = bv == -INFINITY ? -1 - j : bi;
    }
    if (tid == bs && bv != -INFINITY) {
      cv = nv;
      ci = ni;
      ++h;
      const bool more = h + 1 < k_sel;
      nv = more ? pv[h + 1] : -INFINITY;
      ni = more ? pi[h + 1] : INT_MAX;
    }
  }
}

inline void launch_merge(const void* part_v, const void* part_i, void* out_v, void* out_i, int Q,
                         int k_sel, int n_splits, cudaStream_t st) {
  if (n_splits <= MERGE_THREADS)
    segtopk_merge_few<<<Q, MERGE_THREADS, 0, st>>>(
        static_cast<const float*>(part_v), static_cast<const int*>(part_i),
        static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k_sel, n_splits);
  else
    segtopk_merge<<<Q, MERGE_THREADS, sizeof(int) * n_splits, st>>>(
        static_cast<const float*>(part_v), static_cast<const int*>(part_i),
        static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k_sel, n_splits);
}

template <typename Op, int NWG>
int launch_wgmma(const void* q, const void* c, void* part_v, void* part_i, void* out_v,
                 void* out_i, int Q, int n, int D, int L2, int n_valid_segs, int k_sel,
                 int n_splits, int n_stages, cudaStream_t st) {
  constexpr int BQW = NWG * 64;
  constexpr int ELEM = sizeof(typename Op::Elem);
  const size_t bytes = wg_smem_bytes<Op>(BQW, D, n_stages, k_sel);
  // TMA takes 16-byte row pitches; the ring's barriers fit 7 stages
  if ((D * ELEM) % 16 || n_stages < 2 || n_stages > 7 || bytes > (size_t)qc::SMEM_LIMIT ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, cmap;
  int rc = qc::make_tensor_map(&qmap, q, Q, D, BQW, Op::TMA_TYPE, ELEM);
  if (rc) return rc;
  rc = qc::make_tensor_map(&cmap, c, n, D, BN, Op::TMA_TYPE, ELEM);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(segtopk_wgmma_kernel<Op, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long unit = L2 > BN ? L2 : BN;  // split ranges end on segment boundaries
  const long long n_units = ((long long)n_valid_segs * L2 + unit - 1) / unit;
  const long long units_per_split = (n_units + n_splits - 1) / n_splits;
  dim3 grid((Q + BQW - 1) / BQW, n_splits);
  segtopk_wgmma_kernel<Op, NWG><<<grid, (NWG + 1) * qc::WG_THREADS, bytes, st>>>(
      qmap, cmap, static_cast<float*>(part_v), static_cast<int*>(part_i), Q, D, L2, n_valid_segs,
      k_sel, units_per_split * unit, n_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_merge(part_v, part_i, out_v, out_i, Q, k_sel, n_splits, st);
  return (int)cudaGetLastError();
}

template <typename Op>
int launch_tiles(const void* q, const void* c, void* part_v, void* part_i, void* out_v,
                 void* out_i, int Q, int n, int D, int L2, int n_valid_segs, int k_sel,
                 int n_splits, int bq, int n_stages, cudaStream_t st) {
  if (bq == 128)
    return launch_wgmma<Op, 2>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2, n_valid_segs,
                               k_sel, n_splits, n_stages, st);
  if (bq == 64)
    return launch_wgmma<Op, 1>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2, n_valid_segs,
                               k_sel, n_splits, n_stages, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// modes 0 and 1: bf16, the wgmma kernel with bq = 64 or 128 query rows per
// CTA and n_stages = 2..7 ring stages as ops/topk.py planned them (mode 0,
// pass_a_plan: up to 4; mode 1, the overlap schedule, overlap_plan: the
// deepest ring that fits); mode 2: int8, the same kernel on s8 wgmma
// (pass_a_int8_plan; D a multiple of 16); mode 3: f32, the same kernel on
// the 3xTF32 main loop (pass_a_f32_plan: 2-4 stages; D a multiple of 4);
// mode 4: bf16 wider than the resident query tile allows, the same kernel
// on the streamed-query loop (pass_a_wide_plan; D a multiple of 8).
extern "C" int segtopk_pass_a(const void* q, const void* c, void* part_v, void* part_i,
                              void* out_v, void* out_i, int Q, int n, int D, int L2,
                              int n_valid_segs, int k_sel, int n_splits, int mode, int bq,
                              int n_stages, void* stream) {
  if (Q <= 0 || n <= 0 || D <= 0 || L2 <= 0 || k_sel <= 0 || k_sel > 128 || n_splits <= 0 ||
      (BN % L2 != 0 && L2 % BN != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
    case 1:
      return launch_tiles<qc::Bf16Op>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                      n_valid_segs, k_sel, n_splits, bq, n_stages, st);
    case 2:
      return launch_tiles<qc::S8Op>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                    n_valid_segs, k_sel, n_splits, bq, n_stages, st);
    case 3:
      return launch_tiles<tf32q::F32Op>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                        n_valid_segs, k_sel, n_splits, bq, n_stages, st);
    case 4:
      return launch_tiles<qs::Bf16StreamOp>(q, c, part_v, part_i, out_v, out_i, Q, n, D, L2,
                                            n_valid_segs, k_sel, n_splits, bq, n_stages, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
