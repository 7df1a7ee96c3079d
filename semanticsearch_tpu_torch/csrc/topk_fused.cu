// Fused exact top-k: per query, the k best corpus rows by inner product, for
// Hopper (sm_90a), any k up to 2048.
//
// Replaces: semanticsearch_tpu/ops/topk.py::_topk_kernel (the Pallas TPU
// kernel launched by topk_scores_pallas; the dense index's path for k >= 128
// with more than 8192 queries).
//
// What it computes. Queries q (Q, D) and corpus c (N, D), both bf16 or both
// f32, row-major; scores in f32. Rows at or past n_valid never appear. Output per
// query: the top-k (value, row id), ordered by value descending then row id
// ascending (the JAX kernel's k-pass selection: ties keep the lower row).
// When fewer than k rows exist, the tail slots hold value -1e30 and row 0.
//
// What bounds it on this card. 2*Q*N*D multiply-adds against one corpus read:
// at the deep-candidate shapes (thousands of queries, D = 384) it is bound
// by tensor-core throughput and, below that, by the L2 bytes a CTA pulls per
// operation, like pass A. The selection is data-dependent: once a query has
// seen a few k rows, a row survives only if it beats the query's k-th best
// value so far, and the survivors per (query, split) number about
// k * (1 + ln(rows / k)).
//
// What the design does about it.
//  * The main loop is qc_mainloop.cuh (resident 128- or 64-row query tile,
//    TMA + mbarrier ring, wgmma m64n128k16, producer warpgroup). The grid is
//    (query tiles) x (corpus splits); ops/topk.py::fused_plan chooses tile
//    rows, stages, splits and the buffer capacity and passes them in.
//  * The threshold filter runs in the accumulator registers: a thread takes
//    the maxima of its values of each of its two query rows, by groups of 32
//    columns, and looks at single values only in a group whose maximum beats
//    the row's threshold. Rows ascend
//    through a CTA's range, so `v > threshold` alone is exact here: a later
//    row that only ties the k-th best loses to it by its higher row id.
//  * THE DESIGN DECISION: survivors are appended, unsorted, to a buffer of
//    cap = 2k + 128 slots per (query, split) in device memory (one 8-byte
//    store each, the slot taken from a shared-memory counter), as one key
//    that orders like (value descending, row ascending): the f32 bits mapped
//    to an unsigned that sorts like the value, above the complemented row.
//    Nothing is kept sorted while scanning. Only when a buffer could
//    overflow on the next tile (more than cap - 128 entries) does the owning
//    warp cut it back to its best k: a radix select (8 bits a pass, a
//    256-bin histogram in shared memory) finds the k-th largest key, one
//    pass compacts the keys at or above it to the front, and the threshold
//    becomes that key's value. A cut is paid for by at least k + 1
//    survivors, so the cost per survivor is a few buffer reads, instead of a
//    shift of a k-entry sorted list per tile. All 16 query rows of a warp's
//    accumulators belong to that warp alone, so appends and cuts need no
//    barrier beyond __syncwarp. The consumers' other warps keep multiplying
//    meanwhile; the ring runs ahead by its stages.
//  * Ties. Wherever a candidate meets a buffer (the cut, the final sort, the
//    merge) the comparison is on the whole key, so among equal values the
//    lower row wins, within a split and across splits.
//  * After the scan each buffer is cut to at most k, then topk_fused_sort
//    sorts every (query, split) buffer in shared memory (bitonic, keys
//    descending). One split: the sorted buffer is the answer. A few splits:
//    topk_fused_rank_merge places every key by its rank over the buffers in
//    shared memory. Many splits (a small batch over a large corpus):
//    topk_fused_merge takes, k times, the best head over the splits. All
//    read the per-buffer counts, so no sentinel is written anywhere: a
//    query with fewer than k rows ends in (-1e30, 0) slots written last.
//
// The f32 schedule: the same kernel and register epilogue on the 3xTF32
// main loop of tf32_mainloop.cuh (both operands streamed, the corpus box's
// TF32 lo plane written beside it as it lands, the raw box its hi plane,
// three TF32 wgmma products per K step, the small terms in an accumulator
// of their own, summed once per tile). Scores are within about 2^-21 |q| |c| of the plain f32
// product, inside the D * 2^-24 an f32 index may differ by, and equal to it
// bit for bit on integer-valued rows; bound by three TF32 products per score
// at 495 TFLOP/s. TMA needs f32 widths that are multiples of 4 (the wrapper
// pads others with zero columns); ops/topk.py::fused_f32_plan plans it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "qc_mainloop.cuh"
#include "tf32_mainloop.cuh"

namespace {

constexpr int BN = qc::BN;
constexpr int MAX_K = 2048;
constexpr float NEG_INF = -1e30f;
constexpr int HIST_BYTES = 256 * 4;  // one radix histogram per consumer warp

// bytes of shared memory: the main loop's (qc_mainloop.cuh's for bf16,
// tf32_mainloop.cuh's for f32), then per query row a counter and a
// threshold, then the consumer warps' histograms
template <typename Op>
inline size_t fused_smem_bytes(int bq, int D, int n_stages) {
  return tf32q::mainloop_bytes_of<Op>(bq, D, n_stages) + (size_t)bq * 8 +
         (size_t)(bq / 16) * HIST_BYTES;
}

// (value, row) as one unsigned key: larger key = higher value, then lower row
__device__ __forceinline__ unsigned long long make_key(float v, int row) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0;  // -0 orders as +0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)(~row);
}
__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned b = (unsigned)(key >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}
__device__ __forceinline__ int key_row(unsigned long long key) { return (int)(~(unsigned)key); }

// One warp cuts keys[0..count) (count > k) to its k largest, compacted to the
// front in no particular order, and returns the k-th largest key. hist: 256
// words of shared memory of this warp. (Copying the buffer to shared memory
// first, so that the passes do not each go to device memory, was tried and
// measured no faster: the passes are bound by the histogram, not the reads.)
__device__ __noinline__ unsigned long long warp_cut(unsigned long long* keys, int count, int k,
                                                    unsigned* hist) {
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0;  // the digits of the k-th key found so far
  int need = k;                   // its rank among the keys sharing them
  int shift = 56;
  bool unique = false;
  for (;;) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
#pragma unroll 4
    for (int i = lane; i < count; i += 32) {
      const unsigned long long key = keys[i];
      if (shift == 56 || (key >> (shift + 8)) == (prefix >> (shift + 8)))
        atomicAdd(&hist[(unsigned)(key >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane l holds bins 255-8l .. 248-8l; walk the bins from the top
    int mine = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) mine += (int)hist[255 - 8 * lane - b];
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const int excl = incl - mine;
    const bool here = excl < need && need <= incl;
    int digit = 0, rank = 0, bin_count = 0;
    if (here) {
      int seen = excl;
      for (int b = 0; b < 8; ++b) {
        const int h = (int)hist[255 - 8 * lane - b];
        if (seen + h >= need) {
          digit = 255 - 8 * lane - b;
          rank = need - seen;
          bin_count = h;
          break;
        }
        seen += h;
      }
    }
    const int from = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    digit = __shfl_sync(0xffffffffu, digit, from);
    need = __shfl_sync(0xffffffffu, rank, from);
    bin_count = __shfl_sync(0xffffffffu, bin_count, from);
    prefix |= (unsigned long long)digit << shift;
    if (shift == 0) break;
    if (bin_count == 1) {
      unique = true;
      break;
    }
    shift -= 8;
    __syncwarp();
  }
  unsigned long long kth = prefix;
  if (unique) {  // one key carries these digits: fetch its remaining bits
    unsigned long long found = 0;
    for (int i = lane; i < count; i += 32) {
      const unsigned long long key = keys[i];
      if ((key >> shift) == (prefix >> shift)) found = key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, found, off);
      if (other > found) found = other;
    }
    kth = found;
  }
  // keys >= kth to the front, four rounds of 32 loaded at a time; a write
  // never passes the reads of its own batch
  int out = 0;
  for (int base = 0; base < count; base += 128) {
    unsigned long long key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + 32 * u + lane;
      key[u] = i < count ? keys[i] : 0ull;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool keep = base + 32 * u + lane < count && key[u] >= kth;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) keys[out + __popc(m & ((1u << lane) - 1u))] = key[u];
      out += __popc(m);
    }
    __syncwarp();
  }
  return kth;
}

template <typename Op, int NWG>
__global__ void __launch_bounds__((NWG + 1) * qc::WG_THREADS, 1)
topk_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap cmap, unsigned long long* __restrict__ keys,
                  int* __restrict__ counts, int Q, int n_valid, int D, int k, int cap,
                  long long rows_per_split, int n_stages) {
  constexpr int BQW = NWG * 64;
  constexpr int ELEM = sizeof(typename Op::Elem);
  constexpr bool F32 = std::is_same<Op, tf32q::F32Op>::value;  // the 3xTF32 main loop
  extern __shared__ unsigned char smem_raw[];
  const int rb = qc::row_bytes(D, ELEM);
  const int kchunks = rb / qc::CHUNK_BYTES;
  qc::Ring ring;
  tf32q::Ring ring32;
  unsigned char* own;
  if constexpr (F32)
    own = tf32q::ring_setup(ring32, smem_raw, BQW, n_stages, NWG * 4);
  else
    own = qc::ring_setup(ring, smem_raw, BQW, rb, n_stages, NWG * 4);
  int* cnt_s = reinterpret_cast<int*>(own);
  float* thr_s = reinterpret_cast<float*>(own + (size_t)BQW * 4);
  unsigned* hist_s = reinterpret_cast<unsigned*>(own + (size_t)BQW * 8);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQW;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n_valid) r_end = n_valid;
  const int n_tiles = r_begin < r_end ? (int)((r_end - r_begin + BN - 1) / BN) : 0;

  if (tid < BQW) {
    cnt_s[tid] = 0;
    thr_s[tid] = -INFINITY;
  }
  __syncthreads();

  if (tid >= NWG * qc::WG_THREADS) {
    // ------------------------------------------------ producer warpgroup
    if (NWG == 2) qc::reg_dealloc<40>();
    if (tid == NWG * qc::WG_THREADS) {
      if constexpr (F32)
        tf32q::produce(ring32, &qmap, &cmap, q0, kchunks, r_begin, n_tiles);
      else
        qc::produce(ring, &qmap, &cmap, BQW, q0, kchunks, qc::CHUNK_BYTES / ELEM, r_begin,
                    n_tiles);
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    if (NWG == 2) qc::reg_alloc<232>();
    const int wg = tid / qc::WG_THREADS;
    const int warp = tid / 32;  // consumer warp of the CTA
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int row0 = warp * 16;  // the warp's 16 query rows
    const int row_a = row0 + (lane >> 2), row_b = row_a + 8;
    const bool ok_a = q0 + row_a < Q, ok_b = q0 + row_b < Q;
    unsigned long long* keys_a = keys + ((size_t)split * Q + q0 + row_a) * cap;
    unsigned long long* keys_b = keys + ((size_t)split * Q + q0 + row_b) * cap;
    unsigned* hist = hist_s + warp * 256;
    // a row past Q takes nothing
    float thr_a = ok_a ? -INFINITY : INFINITY, thr_b = ok_b ? -INFINITY : INFINITY;

    // cut every buffer of this warp that holds more than `limit` keys
    auto cut_rows = [&](int limit) {
      const int c = lane < 16 ? cnt_s[row0 + lane] : 0;
      unsigned todo = __ballot_sync(0xffffffffu, c > limit);
      if (!todo) return;
      while (todo) {
        const int r = __ffs(todo) - 1;
        todo &= todo - 1;
        const int row = row0 + r;
        const unsigned long long kth = warp_cut(
            keys + ((size_t)split * Q + q0 + row) * cap, cnt_s[row], k, hist);
        __syncwarp();
        if (lane == 0) {
          cnt_s[row] = k;
          thr_s[row] = key_value(kth);
        }
      }
      __syncwarp();
      if (ok_a) thr_a = thr_s[row_a];
      if (ok_b) thr_b = thr_s[row_b];
    };

    auto epilogue = [&](int tile, float (&acc)[64]) {
      const long long r0 = r_begin + (long long)tile * BN;
      const int limit = (int)(r_end - r0 < BN ? r_end - r0 : BN);  // valid columns
      // the thread's maxima over four groups of 32 columns, for each of its
      // two rows; single values are looked at only in a group whose maximum
      // beats the row's threshold (a warp has a few survivors in most tiles)
      float m_a[4], m_b[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        m_a[g] = m_b[g] = -INFINITY;
#pragma unroll
        for (int j = 4 * g; j < 4 * g + 4; ++j) {
          m_a[g] = fmaxf(m_a[g], fmaxf(acc[4 * j], acc[4 * j + 1]));
          m_b[g] = fmaxf(m_b[g], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
        }
      }
      if (fmaxf(fmaxf(m_a[0], m_a[1]), fmaxf(m_a[2], m_a[3])) > thr_a ||
          fmaxf(fmaxf(m_b[0], m_b[1]), fmaxf(m_b[2], m_b[3])) > thr_b) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float thr = h ? thr_b : thr_a;
            if (!((h ? m_b[g] : m_a[g]) > thr)) continue;
#pragma unroll
            for (int j = 4 * g; j < 4 * g + 4; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = acc[4 * j + 2 * h + e];
                const int col = 8 * j + 2 * quad + e;
                if (v > thr && col < limit) {
                  const int pos = atomicAdd(&cnt_s[h ? row_b : row_a], 1);
                  (h ? keys_b : keys_a)[pos] = make_key(v, (int)(r0 + col));
                }
              }
            }
          }
        }
      }
      __syncwarp();
      cut_rows(cap - BN);  // a tile adds at most BN keys to a buffer
    };
    if constexpr (F32)
      tf32q::consume<NWG>(ring32, kchunks, n_tiles, epilogue);
    else
      qc::consume<Op>(ring, wg, BQW, kchunks, n_tiles, epilogue);

    __syncwarp();
    cut_rows(k);
    if (lane < 16 && q0 + row0 + lane < Q)
      counts[(size_t)split * Q + q0 + row0 + lane] = cnt_s[row0 + lane];
  }
}

// Sort one (query, split) buffer's keys, descending, in place: a bitonic
// network over the next power of two in shared memory, padded with key 0
// (below every real key). With one split the sorted buffer IS the answer:
// `direct` writes it to out_v / out_i, with the (-1e30, 0) tail, and no
// merge runs.
constexpr int SORT_THREADS = 128;

__global__ void __launch_bounds__(SORT_THREADS)
topk_fused_sort(unsigned long long* __restrict__ keys, const int* __restrict__ counts, int cap,
                float* __restrict__ out_v, int* __restrict__ out_i, int k, int direct) {
  extern __shared__ unsigned long long sk[];
  const int tid = threadIdx.x;
  const int count = counts[blockIdx.x];
  unsigned long long* mine = keys + (size_t)blockIdx.x * cap;
  int P = 2;
  while (P < count) P <<= 1;
  for (int i = tid; i < P; i += SORT_THREADS) sk[i] = i < count ? mine[i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += SORT_THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool down = (lo & size) == 0;  // this run sorts descending
        const unsigned long long a = sk[lo], b = sk[hi];
        if ((a < b) == down) {
          sk[lo] = b;
          sk[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  if (direct) {
    for (int i = tid; i < k; i += SORT_THREADS) {
      out_v[(size_t)blockIdx.x * k + i] = i < count ? key_value(sk[i]) : NEG_INF;
      out_i[(size_t)blockIdx.x * k + i] = i < count ? key_row(sk[i]) : 0;
    }
  } else {
    for (int i = tid; i < count; i += SORT_THREADS) mine[i] = sk[i];
  }
}

// number of leading entries of a descending array that are > key
__device__ __forceinline__ int count_greater(const unsigned long long* a, int len,
                                             unsigned long long key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge the sorted per-split buffers of one query by rank, when they fit
// shared memory together: a key's place in the answer is its place in its
// own buffer plus the number of larger keys in every other buffer (keys are
// distinct: each carries its row). No round depends on another, so a few
// splits merge in the time of a few binary searches.
constexpr int RANK_THREADS = 256;
constexpr int RANK_SMEM_LIMIT = 96 * 1024;

inline size_t rank_smem_bytes(int k, int n_splits) {
  return (size_t)n_splits * k * 8 + (size_t)(n_splits + 1) * 4;
}

__global__ void __launch_bounds__(RANK_THREADS)
topk_fused_rank_merge(const unsigned long long* __restrict__ keys,
                      const int* __restrict__ counts, float* __restrict__ out_v,
                      int* __restrict__ out_i, int Q, int k, int cap, int n_splits) {
  extern __shared__ unsigned long long sk[];
  int* off = reinterpret_cast<int*>(sk + (size_t)n_splits * k);
  const int qi = blockIdx.x, tid = threadIdx.x;
  for (int s = tid; s < n_splits; s += RANK_THREADS) off[s + 1] = counts[(size_t)s * Q + qi];
  __syncthreads();
  if (tid == 0) {
    off[0] = 0;
    for (int s = 0; s < n_splits; ++s) off[s + 1] += off[s];
  }
  __syncthreads();
  const int total = off[n_splits];
  for (int s = 0; s < n_splits; ++s) {
    const unsigned long long* src = keys + ((size_t)s * Q + qi) * cap;
    for (int i = tid; i < off[s + 1] - off[s]; i += RANK_THREADS) sk[off[s] + i] = src[i];
  }
  __syncthreads();
  for (int e = tid; e < total; e += RANK_THREADS) {
    int lo = 0, hi = n_splits;  // the split holding entry e
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= e) lo = mid; else hi = mid;
    }
    const unsigned long long key = sk[e];
    int rank = e - off[lo];
    for (int t = 0; t < n_splits; ++t)
      if (t != lo) rank += count_greater(sk + off[t], off[t + 1] - off[t], key);
    if (rank < k) {
      out_v[(size_t)qi * k + rank] = key_value(key);
      out_i[(size_t)qi * k + rank] = key_row(key);
    }
  }
  for (int j = total + tid; j < k; j += RANK_THREADS) {  // fewer than k rows in all
    out_v[(size_t)qi * k + j] = NEG_INF;
    out_i[(size_t)qi * k + j] = 0;
  }
}

// The merge for buffers too many for shared memory: k rounds, each taking the
// largest head key over the splits, i.e. the best by (value desc, row asc).
// Slots past the rows that exist hold (-1e30, 0).
constexpr int MERGE_THREADS = 128;

__global__ void __launch_bounds__(MERGE_THREADS)
topk_fused_merge(const unsigned long long* __restrict__ keys, const int* __restrict__ counts,
                 float* __restrict__ out_v, int* __restrict__ out_i, int Q, int k, int cap,
                 int n_splits) {
  extern __shared__ int heads[];
  __shared__ unsigned long long wk[MERGE_THREADS / 32];
  __shared__ int ws[MERGE_THREADS / 32];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int s = tid; s < n_splits; s += MERGE_THREADS) heads[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    unsigned long long best = 0;
    int bs = -1;
    for (int s = tid; s < n_splits; s += MERGE_THREADS) {
      const int h = heads[s];
      if (h >= counts[(size_t)s * Q + qi]) continue;
      const unsigned long long key = keys[((size_t)s * Q + qi) * cap + h];
      if (bs < 0 || key > best) { best = key; bs = s; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long key = __shfl_xor_sync(0xffffffffu, best, off);
      const int s = __shfl_xor_sync(0xffffffffu, bs, off);
      if (s >= 0 && (bs < 0 || key > best)) { best = key; bs = s; }
    }
    if (lane == 0) { wk[warp] = best; ws[warp] = bs; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
        if (ws[w] >= 0 && (bs < 0 || wk[w] > best)) { best = wk[w]; bs = ws[w]; }
      const size_t o = (size_t)qi * k + j;
      if (bs < 0) {  // fewer than k rows in all
        out_v[o] = NEG_INF;
        out_i[o] = 0;
      } else {
        out_v[o] = key_value(best);
        out_i[o] = key_row(best);
        heads[bs] += 1;
      }
    }
    __syncthreads();
  }
}

// After the main kernel: sort each (query, split) buffer and, with several
// splits, merge them per query.
int finish(void* keys, const void* counts, void* out_v, void* out_i, int Q, int k, int n_splits,
           int cap, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int P = 2;
  while (P < k) P <<= 1;
  topk_fused_sort<<<Q * n_splits, SORT_THREADS, sizeof(unsigned long long) * P, st>>>(
      static_cast<unsigned long long*>(keys), static_cast<const int*>(counts), cap,
      static_cast<float*>(out_v), static_cast<int*>(out_i), k, n_splits == 1);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const size_t rank_bytes = rank_smem_bytes(k, n_splits);
  if (rank_bytes <= (size_t)RANK_SMEM_LIMIT) {
    err = cudaFuncSetAttribute(topk_fused_rank_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rank_bytes);
    if (err != cudaSuccess) return (int)err;
    topk_fused_rank_merge<<<Q, RANK_THREADS, rank_bytes, st>>>(
        static_cast<const unsigned long long*>(keys), static_cast<const int*>(counts),
        static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k, cap, n_splits);
  } else {
    topk_fused_merge<<<Q, MERGE_THREADS, sizeof(int) * n_splits, st>>>(
        static_cast<const unsigned long long*>(keys), static_cast<const int*>(counts),
        static_cast<float*>(out_v), static_cast<int*>(out_i), Q, k, cap, n_splits);
  }
  return (int)cudaGetLastError();
}

// rows of a split: whole 128-row tiles
long long split_rows(int n_valid, int n_splits) {
  const long long n_tiles = ((long long)n_valid + BN - 1) / BN;
  return (n_tiles + n_splits - 1) / n_splits * BN;
}

template <typename Op, int NWG>
int launch(const void* q, const void* c, void* keys, void* counts, void* out_v, void* out_i,
           int Q, int n_valid, int D, int k, int n_splits, int n_stages, int cap,
           cudaStream_t st) {
  constexpr int BQW = NWG * 64;
  constexpr int ELEM = sizeof(typename Op::Elem);
  const size_t bytes = fused_smem_bytes<Op>(BQW, D, n_stages);
  // TMA takes 16-byte row pitches
  if ((D * ELEM) % 16 || n_stages < 2 || n_stages > 4 || bytes > (size_t)qc::SMEM_LIMIT ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, cmap;
  int rc = qc::make_tensor_map(&qmap, q, Q, D, BQW, Op::TMA_TYPE, ELEM);
  if (rc) return rc;
  // an empty range starts no copy: its map may stand on any valid address
  rc = qc::make_tensor_map(&cmap, n_valid > 0 ? c : q, n_valid, D, BN, Op::TMA_TYPE, ELEM);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(topk_fused_kernel<Op, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQW - 1) / BQW, n_splits);
  topk_fused_kernel<Op, NWG><<<grid, (NWG + 1) * qc::WG_THREADS, bytes, st>>>(
      qmap, cmap, static_cast<unsigned long long*>(keys), static_cast<int*>(counts), Q, n_valid,
      D, k, cap, split_rows(n_valid, n_splits), n_stages);
  return finish(keys, counts, out_v, out_i, Q, k, n_splits, cap, st);
}

template <typename Op>
int launch_tiles(const void* q, const void* c, void* keys, void* counts, void* out_v,
                 void* out_i, int Q, int n_valid, int D, int k, int n_splits, int bq,
                 int n_stages, int cap, cudaStream_t st) {
  if (bq == 128)
    return launch<Op, 2>(q, c, keys, counts, out_v, out_i, Q, n_valid, D, k, n_splits, n_stages,
                         cap, st);
  if (bq == 64)
    return launch<Op, 1>(q, c, keys, counts, out_v, out_i, Q, n_valid, D, k, n_splits, n_stages,
                         cap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// keys: n_splits * Q * cap 8-byte slots, counts: n_splits * Q ints (scratch,
// uninitialised). bq = 64 or 128 query rows per CTA and n_stages = 2..4 ring
// stages, as ops/topk.py planned them: dtype 0 (bf16) on qc_mainloop.cuh
// (fused_plan), dtype 1 (f32) on the 3xTF32 main loop (fused_f32_plan; D a
// multiple of 4). cap >= k + 128 slots per buffer.
extern "C" int topk_fused(const void* q, const void* c, void* keys, void* counts, void* out_v,
                          void* out_i, int Q, int n_valid, int D, int k, int n_splits, int bq,
                          int n_stages, int cap, int dtype, void* stream) {
  if (Q <= 0 || n_valid < 0 || D <= 0 || k <= 0 || k > MAX_K || n_splits <= 0 || cap < k + BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tiles<qc::Bf16Op>(q, c, keys, counts, out_v, out_i, Q, n_valid, D, k,
                                    n_splits, bq, n_stages, cap, st);
  if (dtype == 1)
    return launch_tiles<tf32q::F32Op>(q, c, keys, counts, out_v, out_i, Q, n_valid, D, k,
                                      n_splits, bq, n_stages, cap, st);
  return (int)cudaErrorInvalidValue;
}
