// The main loop shared by the tensor-core top-k kernels (segtopk.cu modes 0,
// 1 and 2, and topk_fused.cu's bf16 kernel), for Hopper (sm_90a): scores of a
// resident query tile against a streamed corpus range, accumulators in
// registers. Two operand types: bf16 (f32 accumulators, wgmma m64n128k16)
// and int8 (s32 accumulators, wgmma m64n128k32), named by the traits
// Bf16Op and S8Op below.
//
// Both operands are K-major (row-major with the embedding width contiguous),
// which is what wgmma takes for A and B without a transpose, and the only
// layout it takes for 8-bit operands.
//
//  * TMA producer. One elected thread of the producer warpgroup starts every
//    copy. Rows move in K chunks of 128 bytes (64 bf16 or 128 int8 columns).
//    The query tile (BQ rows, BQ = 64 or 128) is loaded once as one box of
//    BQ rows per K chunk and stays resident; the corpus streams as boxes of
//    128 rows x one K chunk (16 KB, one ring stage) in (tile, K chunk) order.
//    Boxes land 128-byte swizzled, the layout the wgmma descriptors name.
//    The tensor maps are encoded with the VALID extents (Q x D and n x D):
//    what a box covers outside them arrives as zeros, which gives the zero
//    query rows past Q, the zero columns past D and "rows at or past n score
//    0" with no address arithmetic.
//  * A ring of 2-7 stages with one full and one empty mbarrier per stage.
//    The producer waits on empty, arms full with the stage's bytes and starts
//    the copy; consumers wait on full, multiply, and each consumer warp
//    arrives on empty once the wgmma group that read the stage has retired.
//    No block barrier inside the loop.
//  * Consumers: one warpgroup per 64 query rows. Per stage four wgmma of 32
//    bytes of K each (k16 bf16 or k32 int8), one commit group per stage, at
//    most one group in flight behind the newest one. A tile's 64 x 128
//    scores end in 64 registers a thread, f32 or s32 in the same layout:
//    thread (warp w, lane l) of the warpgroup holds rows 16w + l/4 and
//    16w + l/4 + 8; register 4j + e is column 8j + 2(l%4) + (e&1) of row
//    l/4 + 8(e>>1). The kernels' epilogues read them there: no score tile is
//    written to shared or device memory.
//    Two consumer warpgroups read the same stages, so they stay at most a
//    ring apart: a ring shorter than a tile keeps them in step; one longer
//    than a tile lets them drift out of phase (segtopk.cu mode 1).
//
// Shared memory, from a 1024-byte aligned base (the swizzle atom):
//   query tile BQ*row_bytes | stages S*16384 | barriers 128 | the kernel's own,
// row_bytes being a query row's bytes rounded up to whole 128-byte chunks.
// The Python wrappers plan BQ and S (ops/topk.py: pass_a_plan,
// pass_a_int8_plan, overlap_plan, fused_plan) and pass them in; the entry
// points recompute the byte count from them with the formulas below and
// refuse what does not fit.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qc {

constexpr int BN = 128;                          // corpus rows per tile
constexpr int CHUNK_BYTES = 128;                 // K chunk of one stage: 64 bf16, 128 int8
constexpr int STAGE_BYTES = BN * CHUNK_BYTES;    // 16384
constexpr int WG_THREADS = 128;
constexpr int SMEM_LIMIT = 232448;               // dynamic shared memory a block can get
constexpr int ALIGN_SLACK = 1024;
constexpr int BAR_BYTES = 128;

// bytes of one query row in shared memory: whole K chunks
__host__ __device__ inline int row_bytes(int D, int elem_bytes) {
  return (D * elem_bytes + CHUNK_BYTES - 1) / CHUNK_BYTES * CHUNK_BYTES;
}

// bytes of the part every kernel has: alignment slack, query tile, ring, barriers
__host__ __device__ inline size_t mainloop_bytes(int bq, int rb, int n_stages) {
  return (size_t)ALIGN_SLACK + (size_t)bq * rb + (size_t)n_stages * STAGE_BYTES + BAR_BYTES;
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map over a row-major matrix of `rows` x `cols` valid elements of
// `elem_bytes` bytes (row pitch a multiple of 16 bytes), box `box_rows` rows
// x one 128-byte K chunk, 128-byte swizzle, zeros outside the extents.
// libcuda's encoder is looked up at run time, so the library links against
// the runtime alone.
inline int make_tensor_map(CUtensorMap* map, const void* base, long long rows, int cols,
                           int box_rows, CUtensorMapDataType dtype, int elem_bytes) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  if (rows < 1) rows = 1;  // an empty range starts no copy; the extent must be positive
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  cuuint32_t box[2] = {(cuuint32_t)(CHUNK_BYTES / elem_bytes), (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  CUresult res = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand: 8-row groups
// 1024 bytes apart. A K step of 32 bytes (16 bf16, 32 int8) inside the
// 128-byte row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  uint64_t d = (uint64_t)((smem_addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;   // leading byte offset: unused for swizzled K-major
  d |= (uint64_t)64 << 32;  // stride byte offset: 1024 bytes
  d |= (uint64_t)1 << 62;   // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous multiplies
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, f32, 64 registers a thread) = or += A (64 x 16) * B (128 x 16)^T,
// both bf16 and K-major in 128-byte-swizzled shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, s32) = or += A (64 x 32) * B (128 x 32)^T, both int8 and
// K-major in 128-byte-swizzled shared memory; every sum exact in int32.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The operand types: element, accumulator, the tensor maps' element type,
// and one wgmma over 32 bytes of K.
struct Bf16Op {
  using Elem = __nv_bfloat16;
  using Acc = float;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n128k16(d, a, b, acc);
  }
};
struct S8Op {
  using Elem = int8_t;
  using Acc = int;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_m64n128k32_s8(d, a, b, acc);
  }
};

// registers move from the producer warpgroup to the consumers
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The ring's places in shared memory.
struct Ring {
  uint32_t q_s;     // query tile: one box of bq rows x 128 bytes per K chunk
  uint32_t stages;  // n_stages boxes of 128 rows x 128 bytes
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  int n_stages;
};

// Lay the ring out from the block's dynamic shared memory and, in thread 0,
// initialise its barriers; returns the first byte after the barriers. Every
// thread calls it, and the block synchronises before any use.
__device__ inline unsigned char* ring_setup(Ring& ring, unsigned char* smem, int bq, int rb,
                                            int n_stages, int n_consumer_warps) {
  const uint32_t addr = smem_u32(smem);
  unsigned char* base = smem + ((ALIGN_SLACK - (addr & (ALIGN_SLACK - 1))) & (ALIGN_SLACK - 1));
  ring.q_s = smem_u32(base);
  ring.stages = ring.q_s + (uint32_t)bq * rb;
  unsigned char* bars = base + (size_t)bq * rb + (size_t)n_stages * STAGE_BYTES;
  ring.full = reinterpret_cast<uint64_t*>(bars);
  ring.empty = ring.full + n_stages;
  ring.q_full = ring.empty + n_stages;
  ring.n_stages = n_stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], n_consumer_warps);
    }
    mbar_init(ring.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  return bars + BAR_BYTES;
}

// Producer (one thread): the query tile, then n_tiles x kchunks corpus boxes;
// a K chunk is chunk_cols = 128 / element size columns.
__device__ inline void produce(const Ring& ring, const CUtensorMap* qmap, const CUtensorMap* cmap,
                               int bq, int q0, int kchunks, int chunk_cols, long long r_begin,
                               int n_tiles) {
  mbar_expect_tx(ring.q_full, (uint32_t)(kchunks * bq * CHUNK_BYTES));
  for (int kc = 0; kc < kchunks; ++kc)
    tma_load_2d(ring.q_s + (uint32_t)kc * bq * CHUNK_BYTES, qmap, ring.q_full, kc * chunk_cols,
                q0);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int row = (int)(r_begin + (long long)tile * BN);
    for (int kc = 0; kc < kchunks; ++kc) {
      mbar_wait(&ring.empty[stage], phase ^ 1);  // passes at once the first time round
      mbar_expect_tx(&ring.full[stage], STAGE_BYTES);
      tma_load_2d(ring.stages + (uint32_t)stage * STAGE_BYTES, cmap, &ring.full[stage],
                  kc * chunk_cols, row);
      if (++stage == ring.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Consumer warpgroup `wg` (all 128 threads): for each tile, the 64 x 128
// scores of its 64 query rows into the accumulators, then on_tile(tile, acc).
// The stages a tile read are released before on_tile runs, so the producer
// loads ahead while the epilogue works, and the other warpgroup multiplies
// on as far as the ring reaches. (A second accumulator set, with the
// next tile's first multiplies started before the epilogue, was tried: the
// assembler then guards the epilogue's register reads with waits of its own
// and serialises the multiplies, which cost more than the overlap gave.)
template <typename Op, typename TileFn>
__device__ __forceinline__ void consume(const Ring& ring, int wg, int bq, int kchunks, int n_tiles,
                                        TileFn&& on_tile) {
  const int lane = threadIdx.x & 31;
  typename Op::Acc acc[64];
  mbar_wait(ring.q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    int pending = -1;  // stage whose multiplies are in flight
    fence_acc(acc);
    for (int kc = 0; kc < kchunks; ++kc) {
      mbar_wait(&ring.full[stage], phase);
      const uint32_t a = ring.q_s + (uint32_t)kc * bq * CHUNK_BYTES +
                         (uint32_t)wg * 64 * CHUNK_BYTES;
      const uint32_t b = ring.stages + (uint32_t)stage * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK_BYTES / 32; ++kk)
        Op::mma(acc, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32), (kc | kk) != 0);
      wgmma_commit();
      if (pending >= 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&ring.empty[pending]);
      }
      pending = stage;
      if (++stage == ring.n_stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&ring.empty[pending]);
    fence_acc(acc);
    on_tile(tile, acc);
  }
}

}  // namespace qc
