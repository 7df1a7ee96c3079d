// The main loop of the two top-k kernels' f32 schedules (segtopk.cu mode 3,
// topk_fused.cu on f32 operands), for Hopper (sm_90a): full-f32 scores of a
// query tile against a streamed corpus range on the TF32 tensor cores, by
// the 3xTF32 split of tf32x3.cuh, accumulators in registers in
// qc_mainloop.cuh's layout, so the kernels' bf16 register epilogues take
// them as they are.
//
// Why both operands stream. qc_mainloop.cuh keeps the query tile resident;
// at D = 384 a 128-row f32 query tile alone is 196,608 of a block's 232,448
// bytes of shared memory, which leaves no room for a stage and its lo
// plane. Here a stage is one 128-byte K chunk (32 f32 columns) of both tiles
// and nothing in shared memory grows with D, so every width fits:
//  * TMA producer (one elected thread): stage = the query tile's BQ rows x
//    one K chunk (the A box, BQ = 64 or 128), the same chunk of the corpus
//    tile's 128 rows (the B box), and a slot for the B box's lo plane:
//    BQ * 128 + 32,768 bytes (48 KB at BQ = 128). Stages go in (corpus
//    tile, K chunk) order; the query tile's chunks come again from L2 for
//    every corpus tile. The tensor maps (qc::make_tensor_map) carry the
//    VALID extents, so rows past Q or n and columns past D arrive as zeros.
//  * The split: the B box stays the raw f32, which the tensor cores read
//    truncated to TF32 as its hi plane; the consumer threads write its lo
//    plane into the third slot (tf32x3::split_stage_lo) one stage ahead of
//    the multiplies and publish it to each other by a named barrier. A is
//    split in registers (hi = tf32(x), lo = tf32(x - hi)): each thread loads
//    its fragments of a K step from the raw A box just before the step's
//    three products.
//  * Products: per 8-column K step, wgmma m64n128k8 tf32 with A from
//    registers (tf32x3::mma_step): small += a_lo b_hi + a_hi b_lo, big +=
//    a_hi b_hi. The two accumulators meet in one f32 add per tile. The
//    first step of a tile writes them without reading them, so neither is
//    live across the epilogue.
//  * A ring of 2-4 stages with one full and one empty mbarrier per stage,
//    as in qc_mainloop.cuh: consumer warps release a stage once the wgmma
//    group that read it retires. The split's barrier keeps the consumer
//    warpgroups in step.
//
// Numerics (tf32x3.cuh): within about 2^-21 |q| |c| of the f32 product.
// On rows that TF32 holds exactly (integers up to 2048 in magnitude) lo = 0,
// the small sum is exactly 0 and the big sum is the exact product wherever
// the sums are integers below 2^24: the plain f32 product bit for bit.
//
// Tried on the card (PERF.md): B's hi plane written in place as well
// (split_stage, as the similarity kernel does; tools/tf32_variants.py times
// it beside this loop): slower. The split done by warps of their own beside
// the TMA thread, marking each stage ready on an mbarrier so that the
// consumer warpgroups never wait for each other: wrong results under
// setmaxnreg (consumers 232 registers, the producer warpgroup 40), right
// without it, but then every thread has 168 registers, the consumers spill
// and pass A is slower than this.
//
// Shared memory, from a 1024-byte aligned base (the swizzle atom):
//   stages S * (BQ * 128 + 32,768) | barriers 128 | the kernel's own.
// ops/topk.py plans BQ and S (pass_a_f32_plan, fused_f32_plan); the entry
// points recompute the bytes with mainloop_bytes_of and refuse a plan that
// does not fit.
#pragma once

#include <type_traits>

#include "qc_mainloop.cuh"
#include "tf32x3.cuh"

namespace tf32q {

constexpr int CHUNK_COLS = qc::CHUNK_BYTES / 4;  // f32 columns of a K chunk

// f32 operands: the tensor maps' element type; products by tf32x3.cuh
struct F32Op {
  using Elem = float;
  using Acc = float;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

__host__ __device__ inline int stage_bytes(int bq) {
  return bq * qc::CHUNK_BYTES + 2 * qc::STAGE_BYTES;
}

// bytes of the part every f32 kernel has: alignment slack, ring, barriers
__host__ __device__ inline size_t mainloop_bytes(int bq, int n_stages) {
  return (size_t)qc::ALIGN_SLACK + (size_t)n_stages * stage_bytes(bq) + qc::BAR_BYTES;
}

// the main loop's bytes for operand type Op: this header's for f32, else
// qc_mainloop.cuh's (a resident query tile of D columns)
template <typename Op>
inline size_t mainloop_bytes_of(int bq, int D, int n_stages) {
  if constexpr (std::is_same<Op, F32Op>::value)
    return mainloop_bytes(bq, n_stages);
  else
    return qc::mainloop_bytes(bq, qc::row_bytes(D, sizeof(typename Op::Elem)), n_stages);
}

struct Ring {
  uint32_t stages;  // n_stages slots of stage_bytes(bq): A box, B box, B's lo plane
  uint64_t* full;
  uint64_t* empty;
  int n_stages;
  int bq;
};

// Lay the ring out and, in thread 0, initialise its barriers; returns the
// first byte after them. Every thread calls it; the block synchronises
// before any use.
__device__ inline unsigned char* ring_setup(Ring& ring, unsigned char* smem, int bq,
                                            int n_stages, int n_consumer_warps) {
  const uint32_t addr = qc::smem_u32(smem);
  unsigned char* base =
      smem + ((qc::ALIGN_SLACK - (addr & (qc::ALIGN_SLACK - 1))) & (qc::ALIGN_SLACK - 1));
  ring.stages = qc::smem_u32(base);
  unsigned char* bars = base + (size_t)n_stages * stage_bytes(bq);
  ring.full = reinterpret_cast<uint64_t*>(bars);
  ring.empty = ring.full + n_stages;
  ring.n_stages = n_stages;
  ring.bq = bq;
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      qc::mbar_init(&ring.full[s], 1);
      qc::mbar_init(&ring.empty[s], n_consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return bars + qc::BAR_BYTES;
}

// Producer (one thread): n_tiles x kchunks stages, each the query tile's
// and the corpus tile's K chunk.
__device__ inline void produce(const Ring& ring, const CUtensorMap* qmap, const CUtensorMap* cmap,
                               int q0, int kchunks, long long r_begin, int n_tiles) {
  const int sb = stage_bytes(ring.bq);
  const uint32_t a_bytes = (uint32_t)ring.bq * qc::CHUNK_BYTES;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row = (int)(r_begin + (long long)tile * qc::BN);
    for (int kc = 0; kc < kchunks; ++kc) {
      qc::mbar_wait(&ring.empty[stage], phase ^ 1);  // passes at once the first time round
      qc::mbar_expect_tx(&ring.full[stage], a_bytes + qc::STAGE_BYTES);
      const uint32_t dst = ring.stages + (uint32_t)stage * sb;
      qc::tma_load_2d(dst, qmap, &ring.full[stage], kc * CHUNK_COLS, q0);
      qc::tma_load_2d(dst + a_bytes, cmap, &ring.full[stage], kc * CHUNK_COLS, row);
      if (++stage == ring.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// D (64 x 128, f32) = A (64 x 8) * B (128 x 8)^T, D written and not read:
// tf32x3::wgmma_m64n128k8_rs without the accumulation, so that the
// compiler knows the old values dead.
__device__ __forceinline__ void wgmma_m64n128k8_rs_first(float (&d)[64], const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
        "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]),
        "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// The three products of one K chunk (four 8-column steps) of the stage at
// `a` (A box) and `b`, `b_lo` (B's two planes); FIRST: the tile's first
// chunk, whose first step writes both accumulators.
template <bool FIRST>
__device__ __forceinline__ void chunk_products(float (&big)[64], float (&small)[64], uint32_t a,
                                               uint32_t b, uint32_t b_lo, int a_row, int t) {
#pragma unroll
  for (int kk = 0; kk < qc::CHUNK_BYTES / 32; ++kk) {
    float x[4];
    uint32_t hi[4], lo[4];
    tf32x3::load_a(x, a, a_row, t, kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      tf32x3::split(x[e], h, l);
      hi[e] = __float_as_uint(h);
      lo[e] = __float_as_uint(l);
    }
    const uint64_t bh = qc::wgmma_desc(b + kk * 32), bl = qc::wgmma_desc(b_lo + kk * 32);
    if (FIRST && kk == 0) {
      wgmma_m64n128k8_rs_first(small, lo, bh);
      tf32x3::wgmma_m64n128k8_rs(small, hi, bl, 1);
      wgmma_m64n128k8_rs_first(big, hi, bh);
    } else {
      tf32x3::mma_step(big, small, hi, lo, bh, bl, false);
    }
  }
}

// Consumer warpgroups, threads 0 .. NWG * 128 - 1 of the block (all call
// it): for each tile, the 64 x 128 scores of warpgroup wg's 64 query rows,
// big + small, then on_tile(tile, acc) with acc in qc_mainloop.cuh's
// register layout. The stages a tile read are released before on_tile
// runs, and the next stage is already split.
template <int NWG, typename TileFn>
__device__ __forceinline__ void consume(const Ring& ring, int kchunks, int n_tiles,
                                        TileFn&& on_tile) {
  constexpr int THREADS = NWG * qc::WG_THREADS;
  const int tid = threadIdx.x;
  const int wg = tid / qc::WG_THREADS, warp = (tid / 32) & 3, lane = tid & 31;
  const int a_row = wg * 64 + warp * 16 + (lane >> 2);  // this thread's A rows: a_row, + 8
  const int sb = stage_bytes(ring.bq);
  const uint32_t a_bytes = (uint32_t)ring.bq * qc::CHUNK_BYTES;
  // a stage, once landed: its B lo plane written, published to every consumer
  auto land = [&](int stage, uint32_t phase) {
    qc::mbar_wait(&ring.full[stage], phase);
    const uint32_t b = ring.stages + (uint32_t)stage * sb + a_bytes;
    tf32x3::split_stage_lo(b, b + qc::STAGE_BYTES, qc::STAGE_BYTES / 4, tid, THREADS);
    tf32x3::fence_split();
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
  };
  const long long steps = (long long)n_tiles * kchunks;
  if (steps == 0) return;
  float big[64], small[64];
  int stage = 0, pending = -1;  // pending: the stage whose multiplies are in flight
  uint32_t phase = 0;
  long long step = 0;
  // one K chunk; `first` (std::integral_constant) marks a tile's first,
  // peeled out of the chunk loop so that the accumulators are dead between
  // tiles in the control flow the compiler sees
  auto chunk = [&](auto first) {
    const uint32_t a = ring.stages + (uint32_t)stage * sb;
    const uint32_t b = a + a_bytes;
    qc::wgmma_fence();
    chunk_products<decltype(first)::value>(big, small, a, b, b + qc::STAGE_BYTES, a_row,
                                           lane & 3);
    qc::wgmma_commit();
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == ring.n_stages) {
      next = 0;
      next_phase ^= 1;
    }
    // the next stage lands and is split under this one's multiplies and,
    // on a ring of three or more, the previous one's too (on two it is the
    // previous one's stage, which has to be released first)
    const bool ahead = ++step < steps;
    if (ahead && ring.n_stages > 2) land(next, next_phase);
    if (pending >= 0) {
      qc::wgmma_wait<1>();
      if (lane == 0) qc::mbar_arrive(&ring.empty[pending]);
    }
    if (ahead && ring.n_stages == 2) land(next, next_phase);
    pending = stage;
    stage = next;
    phase = next_phase;
  };
  land(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    chunk(std::true_type());
    for (int kc = 1; kc < kchunks; ++kc) chunk(std::false_type());
    qc::wgmma_wait<0>();
    if (lane == 0) qc::mbar_arrive(&ring.empty[pending]);
    pending = -1;
    qc::fence_acc(big);
    qc::fence_acc(small);
#pragma unroll
    for (int i = 0; i < 64; ++i) big[i] += small[i];
    on_tile(tile, big);
  }
}

}  // namespace tf32q
