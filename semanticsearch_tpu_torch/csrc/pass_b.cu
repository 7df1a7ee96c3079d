// Pass B of the exact two-pass top-k: each query's candidate segments
// rescored exactly, and its top k of them, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. In the JAX package pass B is XLA after the
// pass-A kernel: a take of the selected segments, an einsum with
// preferred_element_type=f32 and lax.top_k
// (semanticsearch_tpu/ops/topk.py:707-752). The port's plain version
// (ops/topk.py::pass_b_rescore_plain) does the same in torch ops.
//
// What it computes. Queries q (Q, D) and corpus c (>= n rows, D), row-major,
// both bf16 or both f32; seg_ids (Q, k_sel) int32 from pass A, ids < 0 being
// placeholders. Candidate j' = s*L2 + j of a query is row
// max(seg_ids[q, s], 0)*L2 + j; it is valid iff seg_ids[q, s] >= 0 and the
// row is < n. A valid candidate scores the dot product of its row with the
// query, each product exact in f32 and summed in f32 (no TF32); an invalid
// one scores -1e30 and is never read. Output per query: the top k (value
// f32, row id int32), by value descending, ties to the earlier candidate
// position (the stable sort of the plain version, lax.top_k's rule);
// -1e30 slots carry their rows' ids, the clamped rows in candidate order.
//
// What bounds it on this card. The bytes of the DISTINCT selected rows.
// Pass A picks k_sel segments a query, and a segment is picked by many
// queries (at the shard, 32,768 queries x k_sel 11 over 39,063 segments of
// 32 rows: about 9 a segment), so reading a query's rows once for every
// query moves 8.86 GB where the distinct rows are 0.96 GB (0.29 ms at
// 3.35 TB/s). The products are 4.4 G multiply-adds, far below either the
// tensor cores' or the FMA pipes' rate. A design that walks each query's
// rows (a CTA a query) cannot go below the 8.86 GB; reading each selected
// segment once for all the queries that picked it, segment-major, is what
// reaches the bound.
//
// What the design does about it: segment-major, in three stages on the
// caller's stream, with no host synchronisation.
//  1. Bucket the (query, slot) pairs by segment: a counting sort (histogram
//     with warp-aggregated atomics, whose last block scans the counts;
//     scatter). Placeholders and segments wholly past n are dropped; a
//     segment a query lists twice stays two pairs. Each bucket is cut into
//     work items of at most 16 pairs (one MMA tile of queries).
//  2. Score: a CTA an item. It loads the segment's rows (RT <= 32 at a
//     time, clipped to n) and the item's queries into shared memory
//     (cp.async, 16 bytes a lane, a row a warp, where the rows and the
//     corpus are 16-byte aligned; one value a lane otherwise; D in chunks
//     of DC columns) and scores every pair against every row, each warp an
//     8-row slice: bf16 on mma.sync.m16n8k16 (bf16 x bf16 -> f32, exact
//     products, f32 sums, as the JAX einsum on the MXU), f32 on FMAs in
//     column order (never TF32). A segment is read once for each 16 of its
//     pairs: once, on real data (about 9 pairs a segment at the shard); a
//     hot segment is spread over as many CTAs as its pairs need. The grid
//     is bounded on the host (Q * k_sel / 16 plus one a segment); CTAs past
//     the items return at once. Scores go to an f32 scratch (Q, k_sel*L2),
//     one writer each, in a fixed summation order, so two runs give the
//     same bits whatever order the atomics left the pairs in.
//  3. Select: keys are 64-bit, (the order-preserving u32 of the score) <<
//     32 | ~position: distinct, and largest first is value descending then
//     position ascending; -0 keys as +0 and every NaN above every number,
//     as torch.sort orders them. For k <= 128 a threshold leaves about k
//     candidates, ranked by counting (a CTA a query; stage 3 below); past
//     that, k rounds of a warp maximum. Slots of placeholder segments and
//     rows >= n are -1e30 whatever the scratch holds there, so it needs no
//     pre-fill.
// A call launches one memset and four kernels a query chunk; the wrapper
// sizes the chunk so that the scratch stays under its budget.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------ stage 1: bucket the pairs
//
// Two kernels after a memset of the counts. pass_b_hist counts the pairs a
// segment (warp-aggregated atomics); its last block to finish scans the
// counts into each bucket's first pair and first work item (bucket s of c
// pairs gives ceil(c / QROWS) items of at most QROWS pairs).
// pass_b_scatter puts each pair in its bucket and writes the items. The
// segment arrays (Seg) hold n_segs + 3 ints each, rounded up to SCAN_PER:
// start[n_segs] is the number of pairs, start[n_segs + 1] the number of
// items, start[n_segs + 2] the hist blocks done.

constexpr int SORT_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_PER = 8;
constexpr int QROWS = 16;  // pairs a work item: the queries of one MMA tile (m16)

struct Seg {
  int* start;   // counts, then each bucket's first pair
  int* cursor;  // the scatter's next slot a bucket
  int* item;    // each bucket's first work item
};

__device__ __forceinline__ bool real_segment(int seg, int n_segs) {
  return seg >= 0 && seg < n_segs;
}

// counts -> exclusive starts, by one block of SCAN_THREADS: a thread takes 8
// consecutive counts of a piece of 8,192 (two 16-byte loads, coalesced
// across the block; the next piece loaded while this one is scanned), the
// pairs and the items scanned together, packed in a 64-bit sum.
__device__ __forceinline__ void scan_counts(Seg g, int m) {
  __shared__ long long sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int PIECE = SCAN_THREADS * SCAN_PER;
  int4 lo = make_int4(0, 0, 0, 0), hi = lo;
  auto load = [&](int base) {  // from L2: other blocks' atomics wrote them
    const int at = base + (int)threadIdx.x * SCAN_PER;
    if (at <= m) {
      lo = __ldcg(reinterpret_cast<const int4*>(g.start + at));
      hi = __ldcg(reinterpret_cast<const int4*>(g.start + at + 4));
    }
  };
  load(0);
  long long carry = 0;
  for (int base = 0; base < m; base += PIECE) {
    const int at = base + (int)threadIdx.x * SCAN_PER;
    int v[SCAN_PER] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int u = 0; u < SCAN_PER; ++u)
      if (at + u >= m) v[u] = 0;  // the totals and the pad
    if (base + PIECE < m) load(base + PIECE);
    long long w[SCAN_PER], own = 0;
#pragma unroll
    for (int u = 0; u < SCAN_PER; ++u) {
      w[u] = (static_cast<long long>((v[u] + QROWS - 1) / QROWS) << 32) | v[u];
      own += w[u];
    }
    long long x = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long t = sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(FULL, t, o);
        if (lane >= o) t += y;
      }
      sums[lane] = t;
    }
    __syncthreads();
    long long run = carry + x - own + (warp ? sums[warp - 1] : 0);
    carry += sums[SCAN_THREADS / 32 - 1];
    int it[SCAN_PER];
#pragma unroll
    for (int u = 0; u < SCAN_PER; ++u) {
      v[u] = static_cast<int>(run);
      it[u] = static_cast<int>(run >> 32);
      run += w[u];
    }
    if (at + SCAN_PER <= m) {
      const int4 a = make_int4(v[0], v[1], v[2], v[3]), b = make_int4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<int4*>(g.start + at) = a;
      *reinterpret_cast<int4*>(g.start + at + 4) = b;
      *reinterpret_cast<int4*>(g.cursor + at) = a;
      *reinterpret_cast<int4*>(g.cursor + at + 4) = b;
      *reinterpret_cast<int4*>(g.item + at) = make_int4(it[0], it[1], it[2], it[3]);
      *reinterpret_cast<int4*>(g.item + at + 4) = make_int4(it[4], it[5], it[6], it[7]);
    } else {
#pragma unroll
      for (int u = 0; u < SCAN_PER; ++u) {
        if (at + u < m) {
          g.start[at + u] = g.cursor[at + u] = v[u];
          g.item[at + u] = it[u];
        }
      }
    }
    __syncthreads();  // sums is read again by the next piece
  }
  if (threadIdx.x == 0) {
    g.start[m] = static_cast<int>(carry);
    g.start[m + 1] = static_cast<int>(carry >> 32);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
    pass_b_hist(const int* __restrict__ seg_ids, int cnt, int n_segs, Seg g) {
  __shared__ bool last;
  const int i = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int seg = i < cnt ? seg_ids[i] : -1;
  const bool ok = real_segment(seg, n_segs);
  const unsigned peers = __match_any_sync(FULL, ok ? seg : -1);
  if (ok && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(g.start + seg, __popc(peers));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(g.start + n_segs + 2, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_counts(g, n_segs);
}

// pair i (= query * k_sel + slot) to its bucket: (segment, i); and the
// work items (segment, first pair, pairs, 0), a segment a thread
__global__ void __launch_bounds__(SORT_THREADS)
    pass_b_scatter(const int* __restrict__ seg_ids, int cnt, int n_segs, Seg g,
                   int2* __restrict__ pairs, int4* __restrict__ items) {
  const int i = blockIdx.x * SORT_THREADS + threadIdx.x;
  const int seg = i < cnt ? seg_ids[i] : -1;
  const bool ok = real_segment(seg, n_segs);
  const unsigned peers = __match_any_sync(FULL, ok ? seg : -1);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (ok && lane == leader) base = atomicAdd(g.cursor + seg, __popc(peers));
  base = __shfl_sync(FULL, base, leader);
  if (ok) pairs[base + __popc(peers & ((1u << lane) - 1u))] = make_int2(seg, i);
  for (int s = i; s < n_segs; s += gridDim.x * SORT_THREADS) {
    const int first = g.start[s], c = g.start[s + 1] - first, it = g.item[s];
    for (int j = 0; j * QROWS < c; ++j)
      items[it + j] = make_int4(s, first + j * QROWS, min(QROWS, c - j * QROWS), 0);
  }
}

// ------------------------------------------------------- stage 2: score

constexpr int SCORE_WARPS = 4;
constexpr int SCORE_THREADS = 32 * SCORE_WARPS;
// segment rows a tile: one 8-row slice of the output a warp
constexpr int MAX_RT = 8 * SCORE_WARPS;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// rows x dcp values into shared memory (pitch ld), a row a warp: columns
// < dc from the row that row_at(r) points to, zeros from dc on. VEC: values
// a 16-byte cp.async (rows and corpus 16-byte aligned), or 1 (one value a
// lane).
template <typename T, int VEC, typename RowAt>
__device__ __forceinline__ void stage(T* dst, int ld, int rows, int dc, int dcp, RowAt row_at) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += SCORE_WARPS) {
    const T* src = row_at(r);
    T* d = dst + r * ld;
    if constexpr (VEC > 1) {
      for (int col = lane * VEC; col < dcp; col += 32 * VEC) {
        if (col < dc)
          cp_async16(d + col, src + col);
        else
          *reinterpret_cast<uint4*>(d + col) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int col = lane; col < dcp; col += 32) d[col] = col < dc ? src[col] : zero_of<T>();
    }
  }
}

__device__ __forceinline__ unsigned word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// (even, odd) += A (16 x dcp) . S (8 x dcp)^T in the m16n8 accumulator
// layout, the even 16-column steps into one sum and the odd ones into the
// other (two dependency chains; the caller adds them, in a fixed order):
// lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of A against
// rows 2t and 2t + 1 of S. bf16: mma.sync, A row-major and S row-major as
// B's columns, the products exact and the sums f32.
__device__ __forceinline__ void mma_step(float* acc, const __nv_bfloat16* a,
                                         const __nv_bfloat16* a8, const __nv_bfloat16* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(word(a)), "r"(word(a8)), "r"(word(a + 8)), "r"(word(a8 + 8)), "r"(word(b)),
        "r"(word(b + 8)));
}

__device__ __forceinline__ void tile_dot(float* even, float* odd, const __nv_bfloat16* A,
                                         const __nv_bfloat16* S, int ld, int dcp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* a = A + g * ld + 2 * t;
  const __nv_bfloat16* a8 = a + 8 * ld;
  const __nv_bfloat16* b = S + g * ld + 2 * t;
  int k0 = 0;
  for (; k0 + 16 < dcp; k0 += 32) {
    mma_step(even, a + k0, a8 + k0, b + k0);
    mma_step(odd, a + k0 + 16, a8 + k0 + 16, b + k0 + 16);
  }
  if (k0 < dcp) mma_step(even, a + k0, a8 + k0, b + k0);
}

// f32: the same layout on FMAs, each sum in column order (odd unused)
__device__ __forceinline__ void tile_dot(float* acc, float*, const float* A, const float* S,
                                         int ld, int dcp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * ld;
  const float* a1 = a0 + 8 * ld;
  const float* b0 = S + 2 * t * ld;
  const float* b1 = b0 + ld;
  for (int k0 = 0; k0 < dcp; k0 += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k0);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k0);
    const float4 y0 = *reinterpret_cast<const float4*>(b0 + k0);
    const float4 y1 = *reinterpret_cast<const float4*>(b1 + k0);
#define PASS_B_DOT4(o, u_, v_)          \
  acc[o] = fmaf(u_.x, v_.x, acc[o]);    \
  acc[o] = fmaf(u_.y, v_.y, acc[o]);    \
  acc[o] = fmaf(u_.z, v_.z, acc[o]);    \
  acc[o] = fmaf(u_.w, v_.w, acc[o]);
    PASS_B_DOT4(0, x0, y0)
    PASS_B_DOT4(1, x0, y1)
    PASS_B_DOT4(2, x1, y0)
    PASS_B_DOT4(3, x1, y1)
#undef PASS_B_DOT4
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SCORE_THREADS)
    pass_b_score(const T* __restrict__ q, const T* __restrict__ c, const int2* __restrict__ pairs,
                 const int4* __restrict__ items, const int* __restrict__ n_items,
                 float* __restrict__ scores, int D, long long n, int L2, int k_sel, int DC,
                 int RT) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = DC + 16 / (int)sizeof(T);  // 16 bytes of pad: no bank conflicts
  T* S = reinterpret_cast<T*>(smem);         // RT segment rows
  T* A = S + RT * ld;                        // QROWS query rows
  int* slot = reinterpret_cast<int*>(A + QROWS * ld);  // query * k_sel + slot, a pair
  const int4 item = items[blockIdx.x];  // past the items: allocated, unused
  if (static_cast<int>(blockIdx.x) >= *n_items) return;
  const int qn = item.z;  // <= QROWS
  const int2* mine_pairs = pairs + item.y;
  if (threadIdx.x < qn) slot[threadIdx.x] = mine_pairs[threadIdx.x].y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = static_cast<long long>(item.x) * L2;
  const int seg_rows = static_cast<int>(min(static_cast<long long>(L2), n - base));
  for (int row0 = 0; row0 < seg_rows; row0 += RT) {
    const int rows = min(RT, seg_rows - row0);
    const bool mine = warp * 8 < rows;  // this warp's 8-row slice holds rows
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int dc = min(DC, D - d0), dcp = (dc + 15) & ~15;
      __syncthreads();  // the tiles' last readers are done
      stage<T, VEC>(S, ld, rows, dc, dcp,
                    [&](int rr) { return c + (base + row0 + rr) * D + d0; });
      stage<T, VEC>(A, ld, qn, dc, dcp, [&](int rr) {
        return q + static_cast<long long>(__ldg(&mine_pairs[rr].y) / k_sel) * D + d0;
      });
      if (VEC > 1) cp_async_wait_all();
      __syncthreads();
      if (mine) tile_dot(acc[0], acc[1], A, S + warp * 8 * ld, ld, dcp, lane);
    }
    if (mine) {
      const int col = warp * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (g + 8 * h < qn) {
          float* out = scores + static_cast<long long>(slot[g + 8 * h]) * L2 + row0 + col;
          if (col < rows) out[0] = acc[0][2 * h] + acc[1][2 * h];
          if (col + 1 < rows) out[1] = acc[0][2 * h + 1] + acc[1][2 * h + 1];
        }
      }
    }
  }
}

// ------------------------------------------------------ stage 3: select
//
// For k <= 128 (pass_b_select): a CTA a query, of 1 to SELECT_WARPS warps
// (more when there are few queries for the card). Every candidate's key
// goes to shared memory and each lane keeps its M = ceil(k / 32) largest in
// registers; a warp's tau, the k-th largest of its 32 * M list keys, has at
// least k of the warp's keys at or above it, and the largest warp tau has
// every key of the query's top k at or above it. The keys >= that (about k
// of them on real data) are compacted and ranked by counting. For larger
// k, or candidates past the shared memory (pass_b_select_rounds): a warp a
// query, each lane holding its TOPT largest keys; k rounds of a warp
// maximum pop the winner, and a lane rescans its positions when its list
// runs dry.

constexpr int SELECT_WARPS = 4;
constexpr int TOPT = 4;         // keys a lane holds between rescans (rounds)
constexpr int FILL_BATCH = 8;  // positions a lane loads at once
constexpr int FAST_MAX_K = 128;

__device__ __forceinline__ unsigned long long key_of(float s, int pos) {
  const float z = s + 0.0f;  // -0 -> +0: torch.sort holds them equal
  unsigned u = __float_as_uint(z);
  u = s != s ? 0xFFFFFFFFu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(pos));
}

// the score a key was made from (-0 comes back as +0)
__device__ __forceinline__ float value_of(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int position_of(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

__device__ __forceinline__ int segment_of(int p, int L2, int shift) {
  return shift >= 0 ? p >> shift : p / L2;
}

// FILL_BATCH of a lane's positions p0, p0 + stride, ...: their scores, NEG_INF
// where the slot is a placeholder or its row >= n. Every load of the batch
// is issued before any is used (positions past the end read the last
// one): the scratch is read at invalid slots too (it is allocated there),
// and the value dropped.
__device__ __forceinline__ void load_batch(float* v, const float* sc, const int* segs, int p0,
                                           int stride, int ncand, long long n, int L2, int shift) {
  int seg[FILL_BATCH];
#pragma unroll
  for (int u = 0; u < FILL_BATCH; ++u) {
    const int p = min(p0 + stride * u, ncand - 1);
    seg[u] = __ldg(segs + segment_of(p, L2, shift));
    v[u] = sc[p];
  }
#pragma unroll
  for (int u = 0; u < FILL_BATCH; ++u) {
    const int p = p0 + stride * u, j = p - segment_of(p, L2, shift) * L2;
    if (p >= ncand || seg[u] < 0 || static_cast<long long>(seg[u]) * L2 + j >= n) v[u] = NEG_INF;
  }
}

__device__ __forceinline__ int row_of(const int* segs, int p, int L2, int shift) {
  const int s = segment_of(p, L2, shift), seg = __ldg(segs + s);
  return (seg < 0 ? 0 : seg) * L2 + (p - s * L2);
}

// A CTA a query, W = blockDim / 32 <= SELECT_WARPS warps; the host picks W
// so that every lane of every warp holds at least M positions.
template <int M>
__global__ void __launch_bounds__(32 * SELECT_WARPS, 8)
    pass_b_select(const float* __restrict__ scores, const int* __restrict__ seg_ids,
                  float* __restrict__ out_v, int* __restrict__ out_i, long long n, int L2,
                  int k_sel, int k) {
  extern __shared__ unsigned long long keys[];  // a key a candidate position
  __shared__ unsigned long long warp_tau[SELECT_WARPS];
  __shared__ int kept;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, NT = blockDim.x;
  const long long qi = blockIdx.x;
  const int ncand = k_sel * L2;
  const float* sc = scores + qi * ncand;
  const int* segs = seg_ids + qi * k_sel;
  const int shift = (L2 & (L2 - 1)) == 0 ? __ffs(L2) - 1 : -1;
  // 1. the keys, and this lane's M largest (0: an empty slot) of its
  // positions warp * 32 + lane + 32 * W * i
  unsigned long long top[M];
#pragma unroll
  for (int u = 0; u < M; ++u) top[u] = 0;
  for (int p0 = warp * 32 + lane; p0 < ncand; p0 += NT * FILL_BATCH) {
    float v[FILL_BATCH];
    load_batch(v, sc, segs, p0, NT, ncand, n, L2, shift);
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u) {
      const int p = p0 + NT * u;
      if (p >= ncand) break;
      const unsigned long long kk = key_of(v[u], p);
      keys[p] = kk;
      if (kk > top[M - 1]) {
        top[M - 1] = kk;
#pragma unroll
        for (int w = M - 1; w > 0; --w) {
          if (top[w] > top[w - 1]) {
            const unsigned long long x = top[w];
            top[w] = top[w - 1];
            top[w - 1] = x;
          }
        }
      }
    }
  }
  // 2. the warp's tau: its list key of rank k - 1 among the warp's 32 * M
  // (distinct; empty slots rank below every key), so that at least k of the
  // warp's keys, its top k among them, are >= it. The largest warp tau
  // keeps that: every key of the query's top k is >= it.
  int rank[M];
#pragma unroll
  for (int u = 0; u < M; ++u) rank[u] = 0;
#pragma unroll 4
  for (int src = 0; src < 32; ++src) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const unsigned long long w = __shfl_sync(FULL, top[j], src);
#pragma unroll
      for (int u = 0; u < M; ++u) rank[u] += w > top[u];
    }
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int u = 0; u < M; ++u)
    if (top[u] != 0 && rank[u] == k - 1) mine = top[u];
  const unsigned who = __ballot_sync(FULL, mine != 0);
  const unsigned long long held = __shfl_sync(FULL, mine, who ? __ffs(who) - 1 : 0);
  if (lane == 0) warp_tau[warp] = held;  // 0 when no list key has rank k - 1
  if (threadIdx.x == 0) kept = 0;
  __syncthreads();
  unsigned long long tau = warp_tau[0];
  for (int w = 1; w < W; ++w) tau = warp_tau[w] > tau ? warp_tau[w] : tau;
  // 3. the keys >= tau to the front (every key when tau is 0), a chunk of
  // 4 * NT at a time: the whole chunk is read before any write, and the
  // writes land below its end
  const unsigned below = (1u << lane) - 1u;
  for (int c0 = 0; c0 < ncand; c0 += 4 * NT) {
    unsigned long long kk[4];
    unsigned sel[4];
    int at = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = c0 + u * NT + threadIdx.x;
      kk[u] = p < ncand ? keys[p] : 0;
      sel[u] = __ballot_sync(FULL, p < ncand && kk[u] >= tau);
      at += __popc(sel[u]);
    }
    if (lane == 0) at = atomicAdd(&kept, at);
    at = __shfl_sync(FULL, at, 0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if ((sel[u] >> lane) & 1u) keys[at + __popc(sel[u] & below)] = kk[u];
      at += __popc(sel[u]);
    }
    __syncthreads();
  }
  const int cnt = kept;
  // 4. rank the candidates by counting; the first k are the output
  for (int e0 = threadIdx.x; e0 < cnt; e0 += 4 * NT) {
    unsigned long long ke[4];
    int r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * NT;
      ke[u] = e < cnt ? keys[e] : 0;
      r[u] = 0;
    }
#pragma unroll 4
    for (int f = 0; f < cnt; ++f) {
      const unsigned long long kf = keys[f];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] += kf > ke[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e0 + u * NT < cnt && r[u] < k) {
        out_v[qi * k + r[u]] = value_of(ke[u]);
        out_i[qi * k + r[u]] = row_of(segs, position_of(ke[u]), L2, shift);
      }
    }
  }
}

// one lane's largest keys, descending; 0 is an empty slot (every key is > 0)
struct LaneTop {
  unsigned long long key[TOPT];

  // the TOPT largest keys of this lane's positions (lane, lane + 32, ...)
  // below `below` (all of them when `first`)
  __device__ __forceinline__ void fill(const float* sc, const int* segs, int ncand, long long n,
                                       int L2, int shift, int lane, bool first,
                                       unsigned long long below) {
#pragma unroll
    for (int u = 0; u < TOPT; ++u) key[u] = 0;
    for (int p0 = lane; p0 < ncand; p0 += 32 * FILL_BATCH) {
      float v[FILL_BATCH];
      load_batch(v, sc, segs, p0, 32, ncand, n, L2, shift);
#pragma unroll
      for (int u = 0; u < FILL_BATCH; ++u) {
        const int p = p0 + 32 * u;
        if (p >= ncand) break;
        const unsigned long long kk = key_of(v[u], p);
        if ((first || kk < below) && kk > key[TOPT - 1]) {
          key[TOPT - 1] = kk;
#pragma unroll
          for (int w = TOPT - 1; w > 0; --w) {
            if (key[w] > key[w - 1]) {
              const unsigned long long x = key[w];
              key[w] = key[w - 1];
              key[w - 1] = x;
            }
          }
        }
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int u = 0; u + 1 < TOPT; ++u) key[u] = key[u + 1];
    key[TOPT - 1] = 0;
  }
};

__global__ void __launch_bounds__(32 * SELECT_WARPS)
    pass_b_select_rounds(const float* __restrict__ scores, const int* __restrict__ seg_ids,
                         float* __restrict__ out_v, int* __restrict__ out_i, int Qc, long long n,
                         int L2, int k_sel, int k) {
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * SELECT_WARPS + (threadIdx.x >> 5);
  if (qi >= Qc) return;  // the whole warp
  const int ncand = k_sel * L2;
  const float* sc = scores + qi * ncand;
  const int* segs = seg_ids + qi * k_sel;
  const int shift = (L2 & (L2 - 1)) == 0 ? __ffs(L2) - 1 : -1;
  LaneTop top;
  top.fill(sc, segs, ncand, n, L2, shift, lane, true, 0);
  int left = lane < ncand ? (ncand - 1 - lane) / 32 + 1 : 0;  // positions not yet taken
  for (int it = 0; it < k; ++it) {
    const unsigned hi = static_cast<unsigned>(top.key[0] >> 32);
    const unsigned lo = static_cast<unsigned>(top.key[0]);
    const unsigned top_hi = __reduce_max_sync(FULL, hi);
    const unsigned top_lo = __reduce_max_sync(FULL, hi == top_hi ? lo : 0u);
    if (hi == top_hi && lo == top_lo) {  // this lane's head won: keys are distinct
      const unsigned long long won = top.key[0];
      out_v[qi * k + it] = value_of(won);
      out_i[qi * k + it] = row_of(segs, position_of(won), L2, shift);
      top.pop();
      if (--left > 0 && top.key[0] == 0)
        top.fill(sc, segs, ncand, n, L2, shift, lane, false, won);
    }
  }
}

// ------------------------------------------------------------- host side

size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// the scratch layout, the same as ops/topk.py::pass_b_plan's byte count:
// the scores, the pairs, the three segment arrays (n_segs + 3 ints each,
// rounded up to SCAN_PER), then the work items (items_cap of them), each
// region 16-byte aligned
struct Scratch {
  float* scores;
  int2* pairs;
  Seg seg;
  int4* items;
};

long long items_cap(long long cnt, int n_segs) {
  return (cnt + QROWS - 1) / QROWS + (cnt < n_segs ? cnt : n_segs);
}

size_t seg_ints(int n_segs) { return ((size_t)n_segs + 3 + SCAN_PER - 1) / SCAN_PER * SCAN_PER; }

Scratch carve(void* base, int q_chunk, int k_sel, int L2, int n_segs) {
  unsigned char* p = static_cast<unsigned char*>(base);
  Scratch s;
  s.scores = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * (size_t)q_chunk * k_sel * L2);
  s.pairs = reinterpret_cast<int2*>(p);
  p += align16(sizeof(int2) * (size_t)q_chunk * k_sel);
  int* ints = reinterpret_cast<int*>(p);
  s.seg = Seg{ints, ints + seg_ints(n_segs), ints + 2 * seg_ints(n_segs)};
  p += sizeof(int) * 3 * seg_ints(n_segs);
  s.items = reinterpret_cast<int4*>(p);
  return s;
}

int score_smem(int elem, int DC, int RT) {
  return (RT + QROWS) * (DC + 16 / elem) * elem + QROWS * (int)sizeof(int);
}

// a kernel's dynamic shared memory limit, raised to what a launch needs
// when it needs more than any launch before it on this device (the static
// shared memory counts against the same 232,448 bytes)
cudaError_t raise_smem(const void* kernel, int* raised, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) raised[dev] = bytes;
  return err;
}

template <typename T, int VEC>
cudaError_t allow_score(int bytes) {
  static int raised[64];
  return raise_smem(reinterpret_cast<const void*>(pass_b_score<T, VEC>), raised, bytes);
}

template <int M>
cudaError_t allow_select(int bytes) {
  static int raised[64];
  return raise_smem(reinterpret_cast<const void*>(pass_b_select<M>), raised, bytes);
}

int bucket(const int* seg_ids, int cnt, int n_segs, Seg g, int2* pairs, int4* items,
           cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(g.start, 0, sizeof(int) * seg_ints(n_segs), st);
  if (err != cudaSuccess) return (int)err;
  pass_b_hist<<<(cnt + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, st>>>(seg_ids, cnt,
                                                                              n_segs, g);
  pass_b_scatter<<<(cnt + SORT_THREADS - 1) / SORT_THREADS, SORT_THREADS, 0, st>>>(
      seg_ids, cnt, n_segs, g, pairs, items);
  return (int)cudaGetLastError();
}

// W warps a query: up to SELECT_WARPS when there are few queries for the
// card (fewer than 4 * sms CTAs), each lane keeping at least M positions
template <int M>
int select_launch(const float* scores, const int* sid, float* out_v, int* out_i, int qc, long long n,
                  int L2, int k_sel, int k, int sms, cudaStream_t st) {
  const int ncand = k_sel * L2, bytes = 8 * ncand;
  int W = (4 * sms + qc - 1) / qc;
  W = W < SELECT_WARPS ? W : SELECT_WARPS;
  W = W < ncand / (32 * M) ? W : ncand / (32 * M);
  W = W > 1 ? W : 1;
  const cudaError_t err = allow_select<M>(bytes);
  if (err != cudaSuccess) return (int)err;
  pass_b_select<M><<<qc, 32 * W, bytes, st>>>(scores, sid, out_v, out_i, n, L2, k_sel, k);
  return 0;
}

int run_select(const float* scores, const int* sid, float* out_v, int* out_i, int qc, long long n,
               int L2, int k_sel, int k, int sms, cudaStream_t st) {
  if (k <= FAST_MAX_K && 8LL * k_sel * L2 <= SMEM_LIMIT - 1024) {
    if (k <= 32) return select_launch<1>(scores, sid, out_v, out_i, qc, n, L2, k_sel, k, sms, st);
    if (k <= 64) return select_launch<2>(scores, sid, out_v, out_i, qc, n, L2, k_sel, k, sms, st);
    return select_launch<4>(scores, sid, out_v, out_i, qc, n, L2, k_sel, k, sms, st);
  }
  pass_b_select_rounds<<<(qc + SELECT_WARPS - 1) / SELECT_WARPS, 32 * SELECT_WARPS, 0, st>>>(
      scores, sid, out_v, out_i, qc, n, L2, k_sel, k);
  return 0;
}

template <typename T, int VEC>
int run(const void* qv, const void* cv, const int* seg_ids, float* out_v, int* out_i,
        void* scratch, int Q, long long n, int D, int L2, int k_sel, int k, int q_chunk, int sms,
        int DC, int RT, cudaStream_t st) {
  const T* q = static_cast<const T*>(qv);
  const T* c = static_cast<const T*>(cv);
  if (VEC > 1 && (reinterpret_cast<uintptr_t>(c) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
                  (D * sizeof(T)) % 16))
    return (int)cudaErrorInvalidValue;
  const int smem = score_smem((int)sizeof(T), DC, RT);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_score<T, VEC>(smem);
  if (err != cudaSuccess) return (int)err;
  const int n_segs = (int)((n + L2 - 1) / L2);
  const Scratch s = carve(scratch, q_chunk, k_sel, L2, n_segs);
  for (long long q0 = 0; q0 < Q; q0 += q_chunk) {
    const int qc = (int)(Q - q0 < q_chunk ? Q - q0 : q_chunk);
    const int cnt = qc * k_sel;
    const int* sid = seg_ids + q0 * k_sel;
    int status = bucket(sid, cnt, n_segs, s.seg, s.pairs, s.items, st);
    if (status != 0) return status;
    pass_b_score<T, VEC><<<(int)items_cap(cnt, n_segs), SCORE_THREADS, smem, st>>>(
        q + q0 * D, c, s.pairs, s.items, s.seg.start + n_segs + 1, s.scores, D, n, L2, k_sel, DC,
        RT);
    status = run_select(s.scores, sid, out_v + q0 * k, out_i + q0 * k, qc, n, L2, k_sel, k, sms,
                        st);
    if (status != 0) return status;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

bool bad_shape(long long Q, long long n, int L2, int k_sel, int q_chunk) {
  return Q <= 0 || n < 0 || L2 <= 0 || k_sel <= 0 || q_chunk <= 0 ||
         (long long)k_sel * L2 > (1 << 30) || (n + L2 - 1) / L2 >= INT_MAX - 2 * SCAN_THREADS * SCAN_PER ||
         (long long)q_chunk * k_sel > INT_MAX;
}

}  // namespace

// The whole pass B on the stream, in query chunks of q_chunk, with the plan
// of ops/topk.py::pass_b_plan: RT segment rows a tile (a multiple of 8 up
// to 32; the query tile is 16 rows), D in chunks of DC columns (a multiple
// of 16); sms, the card's SMs, sizes the selection's CTAs. f32 = 0: bf16 operands, 1: f32; vec = 1 (one
// value a lane) or 16 bytes a lane (8 bf16 or 4 f32: D * elem a multiple
// of 16, q and c 16-byte aligned). scratch: pass_b_plan's bytes.
extern "C" int pass_b_rescore(const void* q, const void* c, const void* seg_ids, void* out_v,
                              void* out_i, void* scratch, int Q, long long n, int D, int L2,
                              int k_sel, int k, int f32, int vec, int q_chunk, int sms, int DC,
                              int RT, void* stream) {
  if (bad_shape(Q, n, L2, k_sel, q_chunk) || D <= 0 || k <= 0 ||
      (long long)k > (long long)k_sel * L2 || sms <= 0 || RT <= 0 || RT % 8 || RT > MAX_RT ||
      DC <= 0 || DC % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sid = static_cast<const int*>(seg_ids);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
#define PASS_B_RUN(T, V) \
  run<T, V>(q, c, sid, ov, oi, scratch, Q, n, D, L2, k_sel, k, q_chunk, sms, DC, RT, st)
  if (f32) {
    if (vec == 4) return PASS_B_RUN(float, 4);
    if (vec == 1) return PASS_B_RUN(float, 1);
  } else {
    if (vec == 8) return PASS_B_RUN(__nv_bfloat16, 8);
    if (vec == 1) return PASS_B_RUN(__nv_bfloat16, 1);
  }
#undef PASS_B_RUN
  return (int)cudaErrorInvalidValue;
}

// Stage 1 alone, for the tests: seg_ids (Q, k_sel) bucketed into pairs
// (Q * k_sel int2, the first start[n_segs] of them filled), the segment
// arrays at seg (three of seg_ints(n_segs) ints: each bucket's first pair,
// then the number of pairs and of items; the scatter's cursors; each
// bucket's first item) and items (items_cap int4: segment, first pair,
// pairs, 0).
extern "C" int pass_b_bucket(const void* seg_ids, void* pairs, void* seg, void* items, int Q,
                             long long n, int L2, int k_sel, void* stream) {
  if (bad_shape(Q, n, L2, k_sel, Q)) return (int)cudaErrorInvalidValue;
  const int n_segs = (int)((n + L2 - 1) / L2);
  int* ints = static_cast<int*>(seg);
  return bucket(static_cast<const int*>(seg_ids), Q * k_sel, n_segs,
                Seg{ints, ints + seg_ints(n_segs), ints + 2 * seg_ints(n_segs)},
                static_cast<int2*>(pairs), static_cast<int4*>(items),
                static_cast<cudaStream_t>(stream));
}
