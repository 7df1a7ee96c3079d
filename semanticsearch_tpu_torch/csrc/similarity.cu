// Batched Gram matrix S[b] = E[b] E[b]^T in f32, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/similarity.py::_sim_kernel (the Pallas TPU
// kernel launched by similarity_matrix_pallas), and serves every E E^T of
// the chunking path: similarity_matrix, batched_split_signals and
// batched_similarity_matrices.
//
// What it computes. E (B, n, d) f32 or bf16, S (B, n, n) f32 with S[b][i][j]
// = sum_k E[b][i][k] E[b][j][k], accumulated in f32 (the JAX callers ask for
// Precision.HIGHEST). f32 input goes through the 3xTF32 split of tf32x3.cuh:
// within about 2^-21 of the f32 product on unit rows, and equal to it bit
// for bit wherever TF32 holds the inputs exactly and the sums are integers
// below 2^24. bf16 input needs no split: bf16 values are exact operands of a
// bf16 wgmma and their products are exact in f32, so one product suffices.
//
// What bounds it on this card. S is symmetric: B n (n+1) / 2 dot products
// of width d. On the tensor cores, 3 B n (n+1) d operations at 495 TFLOP/s
// (TF32) for f32 input, B n (n+1) d at 989 for bf16, against the bytes of E
// read once and S written once, 4 B n^2. At (1, 4096, 384) that is 0.039 ms
// of operations (f32) against 0.022 ms of bytes; a batch of 64-sentence
// documents is bound by its bytes.
//
// What the design does about it.
//  * Upper triangle only. A CTA owns one 128 x 128 tile (ti, tj), ti <= tj,
//    of one document: a linear index over the triangle of each document's
//    ceil(n / 128) row tiles. Documents of at most 64 rows are stacked,
//    128 / n to a tile (one diagonal tile); the products across two
//    documents are computed and not stored, and where no document crosses
//    the tile's two 64-row halves (64 % n == 0) each consumer warpgroup
//    multiplies only its own half by itself (64 x 64).
//  * Every stored (i, j), i <= j, is the product of row i as A with row j
//    as B in one fixed k order whatever n, the tile or the batch; (j, i)
//    gets the same value. So S == S^T bit for bit by construction, a
//    document gives the same bits alone as in a padded bucket, and two
//    launches agree.
//  * The products run on wgmma: bf16 m64n128k16 (or m64n64k16) for bf16
//    input; 3xTF32 m64n128k8 (or m64n64k8) for f32 input, the small terms
//    in an accumulator of their own, A from registers. Two consumer
//    warpgroups own 64 rows of the tile each.
//  * A TMA ring (qc_mainloop.cuh's tensor maps, mbarriers and descriptors):
//    a producer thread keeps 128-byte K chunks (32 f32 or 64 bf16 columns)
//    of both row blocks in flight; a diagonal tile loads its one block
//    once. E moves as it is, f32 or bf16. For f32 the B box of a stage is
//    split where it lands (tf32x3::split_stage: hi in place, lo into one
//    more slot) by both consumer warpgroups, one stage ahead of the
//    multiplies, and published by a named barrier of the 256 consumer
//    threads; each thread splits its A fragments in registers from the raw
//    A box (on a diagonal tile A is B: it reads them from the split
//    planes). Consumers release a stage when the wgmma group that read it
//    retires; no block barrier in the K loop. Rows past B n and columns
//    past the width arrive as zeros (the map's extents); the rows of the
//    next document a box may cover feed only elements that are not stored.
//    The stage count comes from ops/similarity.py::similarity_plan.
//  * The epilogue stages the tile and its transpose in the ring's room and
//    stores whole rows, four columns a lane: the tile at (ti, tj) and,
//    off the diagonal, its mirror at (tj, ti).
//  * One launch per 65,535 documents (the count the wrapper reports).
// Tried and measured on the card (PERF.md): the hi and lo planes written to
// device memory by a pass of their own (0.103 ms at (1, 4096, 384): L2
// bound), both boxes split in shared memory with A read by wgmma from there
// (0.122), the split done by the producer warpgroup's idle warps (0.144),
// and all of a stage's A fragments loaded before its first multiply or a
// stage ahead (0.1025-0.105, against 0.095 for the fragments of each K step
// loaded just before its three products).
#include "qc_mainloop.cuh"
#include "tf32x3.cuh"

#include <climits>

namespace {

constexpr int TILE = 128;                        // rows of a CTA's row blocks
constexpr int CONSUMERS = 2 * qc::WG_THREADS;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + qc::WG_THREADS;  // and a producer warpgroup
constexpr int MAX_DOCS = 65535;                  // documents a launch takes
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 2 * 8 * MAX_STAGES;    // full and empty a stage
constexpr int BOX_FLOATS = qc::STAGE_BYTES / 4;  // one TMA box of f32
constexpr int T_LD = TILE + 8, TT_LD = TILE + 4;  // the epilogue's two staged tiles
constexpr int STAGING_BYTES = TILE * (T_LD + TT_LD) * 4;  // 137,216, over the ring

struct Geometry {
  long long doc0;  // first document of the launch
  int nb;          // documents in the launch
  int n;           // rows of a document
  int tiles;       // 128-row tiles along a document
  int group;       // documents a tile holds (tiles == 1), else 1
  int pairs;       // tiles (tiles + 1) / 2: a document's triangle
  int kchunks;     // 128-byte K chunks of a row
  int stage_bytes;
  int n_stages;
};

// bf16 D (64 x 64, f32, 32 registers a thread) = or += A (64 x 16) B (64 x
// 16)^T, both K-major in 128-byte-swizzled shared memory (qc_mainloop.cuh's
// m64n128k16 at half the width; the same register layout)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// SPLIT: f32 input, multiplied as 3xTF32; else bf16. A stage holds `boxes`
// TMA boxes (A, and B unless the launch has one tile a document), and for
// f32 one more slot: the lo plane of the box that is split in place (B, or
// A on a diagonal tile, where B is A). A's fragments go to registers: split
// there from the raw A box off the diagonal, read from the split planes on
// it. HALF (one tile a document and no document across the two warpgroups'
// halves, 64 % n == 0): each consumer warpgroup multiplies its own 64 rows
// by themselves, 64 x 64, the products between the halves being products
// across documents, which are not stored.
template <bool SPLIT, bool HALF>
__global__ void __launch_bounds__(THREADS, 1)
gram_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out, const Geometry g) {
  constexpr int CHUNK_COLS = qc::CHUNK_BYTES / (SPLIT ? 4 : 2);
  constexpr int NACC = HALF ? 32 : 64;  // accumulators a thread: 64 x 64 or 64 x 128
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = qc::smem_u32(smem_raw);
  unsigned char* base =
      smem_raw + ((qc::ALIGN_SLACK - (raw & (qc::ALIGN_SLACK - 1))) & (qc::ALIGN_SLACK - 1));
  const uint32_t stages = qc::smem_u32(base);
  // the ring, or the epilogue's staging where that is larger; then the barriers
  const size_t ring = (size_t)g.n_stages * g.stage_bytes;
  unsigned char* bars = base + (ring > STAGING_BYTES ? ring : STAGING_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(bars);
  uint64_t* empty = full + g.n_stages;
  const uint32_t boxes = g.tiles == 1 ? 1 : 2;  // box slots of a stage

  // the tile: a group of whole documents, or (ti, tj) of one document's
  // triangle, row by row
  long long doc;
  int ti = 0, tj = 0, docs = 1;
  if (g.tiles == 1) {
    doc = g.doc0 + (long long)blockIdx.x * g.group;
    docs = (int)min((long long)g.group, g.doc0 + g.nb - doc);
  } else {
    doc = g.doc0 + blockIdx.x / g.pairs;
    int p = blockIdx.x % g.pairs;
    while (p >= g.tiles - ti) {
      p -= g.tiles - ti;
      ++ti;
    }
    tj = ti + p;
  }
  const bool diag = ti == tj;
  const int loaded = diag ? 1 : 2;  // boxes this CTA loads a stage
  const int row_a = (int)(doc * g.n) + ti * TILE;  // the wrapper keeps B n below 2^31
  const int row_b = (int)(doc * g.n) + tj * TILE;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.n_stages; ++s) {
      qc::mbar_init(&full[s], 1);
      qc::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------- producer
    qc::reg_dealloc<40>();
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kc = 0; kc < g.kchunks; ++kc) {
        qc::mbar_wait(&empty[stage], phase ^ 1);  // passes at once the first time round
        qc::mbar_expect_tx(&full[stage], loaded * qc::STAGE_BYTES);
        const uint32_t dst = stages + (uint32_t)stage * g.stage_bytes;
        const int col = kc * CHUNK_COLS;
        qc::tma_load_2d(dst, &map, &full[stage], col, row_a);
        if (!diag) qc::tma_load_2d(dst + qc::STAGE_BYTES, &map, &full[stage], col, row_b);
        if (++stage == g.n_stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers
  qc::reg_alloc<232>();
  const int wg = tid / qc::WG_THREADS, warp = (tid / 32) & 3, lane = tid & 31;
  // a stage, once landed; f32: its B box split, hi in place and lo in the
  // last slot, published to both consumer warpgroups by their own barrier
  const uint32_t b_slot = diag ? 0 : qc::STAGE_BYTES, lo_slot = boxes * qc::STAGE_BYTES;
  auto land = [&](int stage, uint32_t phase) {
    qc::mbar_wait(&full[stage], phase);
    if constexpr (SPLIT) {
      const uint32_t s0 = stages + (uint32_t)stage * g.stage_bytes;
      tf32x3::split_stage(s0 + b_slot, s0 + lo_slot, BOX_FLOATS, tid, CONSUMERS);
      tf32x3::fence_split();
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    }
  };
  const int a_row = wg * 64 + warp * 16 + (lane >> 2);  // this thread's A rows: a_row, + 8
  // f32: this thread's hi and lo A fragment of K step kk of the stage at s0
  auto a_frags = [&](uint32_t s0, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    float x[4];
    tf32x3::load_a(x, s0, a_row, lane & 3, kk);
    if (diag) {  // the box is split already: x is hi, lo is in the last slot
      float y[4];
      tf32x3::load_a(y, s0 + lo_slot, a_row, lane & 3, kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __float_as_uint(x[e]);
        lo[e] = __float_as_uint(y[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h, l;
        tf32x3::split(x[e], h, l);
        hi[e] = __float_as_uint(h);
        lo[e] = __float_as_uint(l);
      }
    }
  };
  float big[NACC], small[NACC];
  int stage = 0, pending = -1;
  uint32_t phase = 0;
  land(0, 0);
  for (int kc = 0; kc < g.kchunks; ++kc) {
    const uint32_t s0 = stages + (uint32_t)stage * g.stage_bytes;
    const uint32_t a = s0 + (uint32_t)wg * 64 * qc::CHUNK_BYTES;  // this warpgroup's 64 rows
    // B: the tile's 128 rows, or (HALF) this warpgroup's own 64; its lo
    // plane at the same place in the last slot
    const uint32_t b = HALF ? a : s0 + b_slot;
    const uint32_t b_lo = b - b_slot + lo_slot;
    qc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < qc::CHUNK_BYTES / 32; ++kk) {
      const uint32_t off = kk * 32;
      if constexpr (SPLIT) {  // each K step's fragments just before its three products
        uint32_t hi[4], lo[4];
        a_frags(s0, kk, hi, lo);
        tf32x3::mma_step(big, small, hi, lo, qc::wgmma_desc(b + off),
                         qc::wgmma_desc(b_lo + off), (kc | kk) == 0);
      } else if constexpr (HALF) {
        wgmma_m64n64k16(big, qc::wgmma_desc(a + off), qc::wgmma_desc(b + off), (kc | kk) != 0);
      } else {
        qc::wgmma_m64n128k16(big, qc::wgmma_desc(a + off), qc::wgmma_desc(b + off),
                             (kc | kk) != 0);
      }
    }
    qc::wgmma_commit();
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == g.n_stages) {
      next = 0;
      next_phase ^= 1;
    }
    // the next stage lands and is split under this one's multiplies and,
    // on a ring of three or more, the previous one's too (on two it is the
    // previous one's stage, which has to be released first)
    const bool ahead = kc + 1 < g.kchunks;
    if (ahead && g.n_stages > 2) land(next, next_phase);
    if (pending >= 0) {
      qc::wgmma_wait<1>();
      if (lane == 0) qc::mbar_arrive(&empty[pending]);
    }
    if (ahead && g.n_stages == 2) land(next, next_phase);
    pending = stage;
    stage = next;
    phase = next_phase;
  }
  qc::wgmma_wait<0>();
  fence_acc(big);
  if constexpr (SPLIT) fence_acc(small);

  // Epilogue, staged in shared memory (the ring is idle now) so that every
  // store is coalesced. T[r][c] holds the value of tile row r and column c
  // (written a column pair at a time), Tt[c][r] the same value (written a
  // float at a time); the strides keep both writes free of bank conflicts.
  // Then each warp writes tile rows, four columns a lane: the block (ti,
  // tj) from T and, off the diagonal, its mirror (tj, ti) from Tt. A row or
  // column lies in document doc + (its index along the tile) / n; an element
  // is stored where both lie in the same document of this tile; on a
  // diagonal block element (i, j) is T's where i <= j and Tt's (the value of
  // (j, i)) below, so S is a copy of its own upper triangle.
  float* T = reinterpret_cast<float*>(base);
  float* Tt = T + TILE * T_LD;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // the ring is read out
  {
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);
    const int c0 = (HALF ? wg * 64 : 0) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = c0 + 8 * j, e = 4 * j + 2 * h;
        const float v0 = SPLIT ? big[e] + small[e] : big[e];
        const float v1 = SPLIT ? big[e + 1] + small[e + 1] : big[e + 1];
        *reinterpret_cast<float2*>(T + r * T_LD + c) = make_float2(v0, v1);
        Tt[c * TT_LD + r] = v0;
        Tt[(c + 1) * TT_LD + r] = v1;
      }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  const int n = g.n;
  const long long nn = (long long)n * n;
  const int c = 4 * lane;  // this lane's four tile columns, in rows tid / 32 + 8k
  for (int blk = 0; blk < (diag ? 1 : 2); ++blk) {
    const int rt = blk ? tj : ti, ct = blk ? ti : tj;
    const float* src = blk ? Tt : T;
    const int ld = blk ? TT_LD : T_LD;
    int cd[4], cj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lj = ct * TILE + c + e;
      cd[e] = lj / n;
      cj[e] = lj - cd[e] * n;
    }
    const bool vec = n % 4 == 0 && cd[0] == cd[3];
#pragma unroll 4
    for (int r = tid >> 5; r < TILE; r += CONSUMERS / 32) {
      const int li = rt * TILE + r;
      const int rd = li / n, i = li - rd * n;
      if (rd >= docs) continue;
      float4 v = *reinterpret_cast<const float4*>(src + r * ld + c);
      if (diag) {  // below the diagonal: the mirror's value
        const float4 m = *reinterpret_cast<const float4*>(Tt + r * TT_LD + c);
        if (i > cj[0]) v.x = m.x;
        if (i > cj[1]) v.y = m.y;
        if (i > cj[2]) v.z = m.z;
        if (i > cj[3]) v.w = m.w;
      }
      float* row = out + (doc + rd) * nn + (long long)i * n;
      if (vec && cd[0] == rd) {
        *reinterpret_cast<float4*>(row + cj[0]) = v;
      } else {
        if (cd[0] == rd) row[cj[0]] = v.x;
        if (cd[1] == rd) row[cj[1]] = v.y;
        if (cd[2] == rd) row[cj[2]] = v.z;
        if (cd[3] == rd) row[cj[3]] = v.w;
      }
    }
  }
}

// the kernel's dynamic shared-memory limit, set once a device
template <bool SPLIT, bool HALF>
int allow_smem() {
  static unsigned long long set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && (set >> dev & 1)) return 0;
  err = cudaFuncSetAttribute(gram_kernel<SPLIT, HALF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, qc::SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) set |= 1ull << dev;
  return 0;
}

template <bool SPLIT>
int gram(const void* emb, float* out, int B, int n, int d, int n_stages, cudaStream_t st,
         int* launched) {
  const int elem = SPLIT ? 4 : 2;
  CUtensorMap map;
  int rc = qc::make_tensor_map(
      &map, emb, (long long)B * n, d, TILE,
      SPLIT ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, elem);
  if (rc) return rc;
  Geometry g;
  g.n = n;
  g.tiles = (n + TILE - 1) / TILE;
  g.group = g.tiles == 1 ? TILE / n : 1;
  g.pairs = g.tiles * (g.tiles + 1) / 2;
  g.kchunks = (d * elem + qc::CHUNK_BYTES - 1) / qc::CHUNK_BYTES;
  g.stage_bytes = ((g.tiles == 1 ? 1 : 2) + (SPLIT ? 1 : 0)) * qc::STAGE_BYTES;
  g.n_stages = n_stages;
  const size_t ring = (size_t)n_stages * g.stage_bytes;
  const size_t bytes =
      (size_t)qc::ALIGN_SLACK + (ring > STAGING_BYTES ? ring : STAGING_BYTES) + BAR_BYTES;
  if (n_stages < (g.kchunks > 1 ? 2 : 1) || n_stages > MAX_STAGES ||
      bytes > (size_t)qc::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const bool half = g.tiles == 1 && 64 % n == 0;
  rc = half ? allow_smem<SPLIT, true>() : allow_smem<SPLIT, false>();
  if (rc) return rc;
  for (int b0 = 0; b0 < B; b0 += MAX_DOCS) {
    g.doc0 = b0;
    g.nb = B - b0 < MAX_DOCS ? B - b0 : MAX_DOCS;
    const long long ctas =
        g.tiles == 1 ? (g.nb + g.group - 1) / g.group : (long long)g.nb * g.pairs;
    if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
    if (half)
      gram_kernel<SPLIT, true><<<(unsigned)ctas, THREADS, bytes, st>>>(map, out, g);
    else
      gram_kernel<SPLIT, false><<<(unsigned)ctas, THREADS, bytes, st>>>(map, out, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

}  // namespace

// emb (B, n, d) contiguous and 16-byte aligned with 16-byte rows (d a
// multiple of 4 for f32, of 8 for bf16: the wrapper pads), B n below 2^31;
// out (B, n, n) f32. dtype 0: f32, 1: bf16. n_stages: the ring's depth
// (similarity_plan). Returns cudaGetLastError() after the launches (one per
// 65,535 documents) and adds the number launched to *launched.
extern "C" int similarity_gram(const void* emb, void* out, int B, int n, int d, int dtype,
                               int n_stages, void* stream, int* launched) {
  if (B <= 0 || n <= 0 || d <= 0 || (long long)B * n > INT_MAX ||
      reinterpret_cast<uintptr_t>(emb) % 16 || d % (dtype == 0 ? 4 : 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return gram<true>(emb, o, B, n, d, n_stages, st, launched);
  if (dtype == 1) return gram<false>(emb, o, B, n, d, n_stages, st, launched);
  return (int)cudaErrorInvalidValue;
}
