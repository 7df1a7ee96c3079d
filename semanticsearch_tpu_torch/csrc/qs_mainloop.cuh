// The bf16 main loop of pass A's wide schedule (segtopk.cu mode 4), for
// Hopper (sm_90a): qc_mainloop.cuh's products and accumulator layout, with
// the query tile streamed through the ring beside the corpus tile instead
// of held resident.
//
// Why. qc_mainloop.cuh keeps the whole query tile in shared memory, BQ rows
// x D bf16: at D = 2,048 a 64-row tile is 262,144 bytes, more than a block
// can have, so the resident schedules stop at ops/topk.py::pass_a_max_d
// (1,536 columns at k_sel 1, 1,024 at 128). Here a stage is one 128-byte K
// chunk (64 columns) of both tiles, the layout tf32_mainloop.cuh uses for
// f32, and nothing in shared memory grows with D:
//  * TMA producer (one elected thread): stage = the query tile's BQ rows x
//    one K chunk (the A box, BQ = 64 or 128) and the same chunk of the
//    corpus tile's 128 rows (the B box): BQ * 128 + 16,384 bytes (32 KB at
//    BQ = 128). Stages go in (corpus tile, K chunk) order, so the query
//    tile's chunks come again from L2 for every corpus tile: at BQ = 128
//    the CTA reads as many query bytes as corpus bytes from L2, and the
//    corpus alone from device memory.
//  * Consumers: one warpgroup per 64 query rows, four wgmma m64n128k16 a
//    stage with A and B both from the stage (each warpgroup its own 64 rows
//    of the A box), one commit group a stage, at most one in flight behind
//    the newest, each consumer warp arriving on the stage's empty barrier
//    once the group that read it has retired, as in qc_mainloop.cuh. The
//    scores end in the same 64 registers a thread, so segtopk.cu's
//    epilogue takes them as they are: the same selections, the same ties.
//
// Shared memory, from a 1024-byte aligned base (the swizzle atom; every
// stage and both boxes in it start on one):
//   stages S * (BQ * 128 + 16,384) | barriers 128 | the kernel's own.
// ops/topk.py plans BQ and S (pass_a_wide_plan); segtopk.cu recomputes the
// bytes with mainloop_bytes and refuses a plan that does not fit.
#pragma once

#include "qc_mainloop.cuh"

namespace qs {

// bf16 operands on the streamed loop: qc::Bf16Op's element, accumulator,
// tensor-map type and wgmma, under a type of its own
struct Bf16StreamOp : qc::Bf16Op {};

__host__ __device__ inline int stage_bytes(int bq) {
  return bq * qc::CHUNK_BYTES + qc::STAGE_BYTES;
}

// bytes of the main loop: alignment slack, ring, barriers
__host__ __device__ inline size_t mainloop_bytes(int bq, int n_stages) {
  return (size_t)qc::ALIGN_SLACK + (size_t)n_stages * stage_bytes(bq) + qc::BAR_BYTES;
}

struct Ring {
  uint32_t stages;  // n_stages slots of stage_bytes(bq): A box, then B box
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
// and the corpus tile's K chunk (64 bf16 columns).
__device__ inline void produce(const Ring& ring, const CUtensorMap* qmap, const CUtensorMap* cmap,
                               int q0, int kchunks, long long r_begin, int n_tiles) {
  constexpr int CHUNK_COLS = qc::CHUNK_BYTES / 2;
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

// Consumer warpgroup `wg` (all 128 threads): for each tile, the 64 x 128
// scores of its 64 query rows into the accumulators, then on_tile(tile,
// acc), the stages the tile read released first (qc::consume's order).
template <typename Op, typename TileFn>
__device__ __forceinline__ void consume(const Ring& ring, int wg, int kchunks, int n_tiles,
                                        TileFn&& on_tile) {
  const int lane = threadIdx.x & 31;
  const int sb = stage_bytes(ring.bq);
  const uint32_t a_bytes = (uint32_t)ring.bq * qc::CHUNK_BYTES;
  const uint32_t a_row = (uint32_t)wg * 64 * qc::CHUNK_BYTES;  // this warpgroup's rows
  typename Op::Acc acc[64];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    int pending = -1;  // stage whose multiplies are in flight
    qc::fence_acc(acc);
    for (int kc = 0; kc < kchunks; ++kc) {
      qc::mbar_wait(&ring.full[stage], phase);
      const uint32_t s = ring.stages + (uint32_t)stage * sb;
      const uint32_t a = s + a_row, b = s + a_bytes;
      qc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < qc::CHUNK_BYTES / 32; ++kk)
        Op::mma(acc, qc::wgmma_desc(a + kk * 32), qc::wgmma_desc(b + kk * 32), (kc | kk) != 0);
      qc::wgmma_commit();
      if (pending >= 0) {
        qc::wgmma_wait<1>();
        if (lane == 0) qc::mbar_arrive(&ring.empty[pending]);
      }
      pending = stage;
      if (++stage == ring.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    qc::wgmma_wait<0>();
    if (lane == 0) qc::mbar_arrive(&ring.empty[pending]);
    qc::fence_acc(acc);
    on_tile(tile, acc);
  }
}

}  // namespace qs
