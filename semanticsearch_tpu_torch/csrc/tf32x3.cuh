// Full-f32 products on the TF32 tensor cores, for Hopper (sm_90a): the
// 3xTF32 split. Used by similarity.cu, by tf32_mainloop.cuh (the top-k
// kernels' f32 schedules) and by flash_attention.cu (its f32 products, on
// mma.sync): every f32 product of the port that wants the tensor cores'
// rate without their 10-bit mantissa.
//
// An f32 value x splits into two TF32 values (f32 bit patterns whose low 13
// mantissa bits are zero), both rounded to nearest with cvt.rna:
//     hi = tf32(x),  lo = tf32(x - hi)      (x - hi is exact in f32)
// so x = hi + lo to within 2^-22 |x|. A dot product then takes three TF32
// products, each exact in f32 (11-bit by 11-bit significands):
//     a.b ~ (a_lo.b_hi + a_hi.b_lo) + a_hi.b_hi
// dropping a_lo.b_lo (at most 2^-22 |a||b|). The two small terms go into an
// accumulator of their own, so the tensor cores' rounding of their running
// sum happens at their scale, about 2^-11 of the big one's; the two sums
// meet in one f32 add at the end. On values that TF32 holds exactly (every
// integer up to 2048 in magnitude, every bf16 value) lo = 0, the small sum
// is exactly 0, and the big sum is the plain f32 product: exact wherever
// the sums are integers below 2^24.
//
// The split is done where the operands land: split_stage turns a TMA box of
// f32 in shared memory into its hi plane in place and writes its lo plane
// beside it, in the same 128-byte-swizzled layout (the split is elementwise
// and both planes start on 1024-byte boundaries). So E moves through memory
// once, as f32. The tensor cores then read both planes as they are: the low
// 13 bits they would otherwise ignore (truncation) are already zero.
//
// The product: wgmma m64n128k8 (or m64n64k8) tf32 with A from registers and
// B K-major in 128-byte-swizzled shared memory (the only layout wgmma takes
// for tf32; it is E's own), 8 columns = 32 bytes of K an instruction, so a
// 128-byte K chunk of a TMA box is four of them at 32-byte steps of the
// descriptor, as in qc_mainloop.cuh's bf16 and int8 loops. A in registers
// spares the shared memory a third of what the three products read, and an
// operand split in registers need not be written back (load_a, split).
//
// The register form (mma_m16n8k8, mma3_m16n8k8) takes both operands from
// registers, so a kernel that has no room for lo planes splits each
// fragment as it loads it; there the raw f32 value is its own hi part and
// lo_of_raw gives x - trunc(x), two integer-unit operations and no
// conversion.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - hi);
}

// Split `floats` f32 values (a multiple of 4 * threads) at shared address
// `box` in place into their hi parts, their lo parts to `lo` at the same
// offsets; `thread` of `threads` takes every threads-th 16 bytes. The
// caller orders these generic-proxy writes before wgmma's reads (or a TMA
// write into the same bytes) with fence_split() and a barrier.
__device__ __forceinline__ void split_stage(uint32_t box, uint32_t lo, int floats, int thread,
                                            int threads) {
  for (int i = thread * 16; i < floats * 4; i += threads * 16) {
    float4 v, h, l;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(box + i));
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(box + i), "f"(h.x),
                 "f"(h.y), "f"(h.z), "f"(h.w)
                 : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + i), "f"(l.x),
                 "f"(l.y), "f"(l.z), "f"(l.w)
                 : "memory");
  }
}

// The lo parts of `floats` f32 values at shared address `box` to `lo` at
// the same offsets, for a box whose raw f32 values the TF32 products read
// as its hi parts: the tensor cores drop the low 13 mantissa bits of a TF32
// operand (truncation), so hi = trunc(x) and lo = tf32(x - trunc(x)), the
// difference exact in f32 and lo within 2^-21 |x| of it; the box itself is
// not written. Integer values up to 2048 in magnitude have lo = 0. `thread`
// of `threads` takes every threads-th 16 bytes; the caller orders these
// writes before wgmma's reads as for split_stage.
__device__ __forceinline__ void split_stage_lo(uint32_t box, uint32_t lo, int floats, int thread,
                                               int threads) {
#pragma unroll 4
  for (int i = thread * 16; i < floats * 4; i += threads * 16) {
    float v[4], l[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(box + i));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      l[e] = round_tf32(v[e] - __uint_as_float(__float_as_uint(v[e]) & ~0x1FFFu));
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + i), "f"(l[0]),
                 "f"(l[1]), "f"(l[2]), "f"(l[3])
                 : "memory");
  }
}

// The lo part of x for an operand passed raw as its own hi part (the
// tensor cores truncate it to TF32): x - trunc(x), exact in f32, which the
// tensor cores truncate in turn (within 2^-20 |x| of it). Two integer
// operations' worth, no conversion; 0 for every value TF32 holds.
__device__ __forceinline__ uint32_t lo_of_raw(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & ~0x1FFFu));
}

// D (16 x 8, f32) += A (16 x 8) * B (8 x 8), TF32 operands, f32
// accumulators: mma.sync's register form, one warp. a[0..3]: A's (l/4, l%4),
// (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4); b0, b1: B's (k l%4,
// n l/4) and (k l%4 + 4, n l/4); d[0..3]: D's (l/4, 2(l%4) + {0, 1}) and
// (l/4 + 8, 2(l%4) + {0, 1}), l the lane. An ldmatrix (b16, not transposed)
// of 8 rows of 4 f32 gives lane l the f32 at row l/4, column l%4: A's and
// B's layouts for row-major A and B^T.
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3xTF32 step of the register form on raw f32 operands (each its own
// hi part, lo = lo_of_raw): small += a_lo b_hi + a_hi b_lo, big += a_hi b_hi.
// small and big may be the same accumulator (the small terms folded in).
__device__ __forceinline__ void mma3_m16n8k8(float (&big)[4], float (&small)[4],
                                             const uint32_t (&a)[4], const uint32_t (&a_lo)[4],
                                             uint32_t b0, uint32_t b1) {
  mma_m16n8k8(small, a_lo, b0, b1);
  mma_m16n8k8(small, a, lo_of_raw(b0), lo_of_raw(b1));
  mma_m16n8k8(big, a, b0, b1);
}

// this thread's shared-memory writes before the async proxy's (wgmma, TMA)
// accesses to the same bytes
__device__ __forceinline__ void fence_split() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 128, f32, 64 registers a thread) = or += A (64 x 8) * B (128 x 8)^T,
// A from registers (a TF32 value a register), B TF32 and K-major in 128-byte
// swizzled shared memory. This thread's a[0..3] are A's elements (l/4, l%4),
// (l/4 + 8, l%4), (l/4, l%4 + 4) and (l/4 + 8, l%4 + 4) of its warp's 16
// rows and the step's 8 columns, l the lane (mma.sync's m16n8k8 tf32
// layout); D's layout is qc_mainloop.cuh's (register 4j + e: column 8j +
// 2(l%4) + (e&1) of row l/4 + 8(e>>1)).
__device__ __forceinline__ void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The same at N = 64: D (64 x 64, 32 registers a thread, the same layout).
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int NACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NACC], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  if constexpr (NACC == 64)
    wgmma_m64n128k8_rs(d, a, b, acc);
  else
    wgmma_m64n64k8_rs(d, a, b, acc);
}

// One 8-column K step of the split product, small terms first:
// small += a_lo b_hi^T + a_hi b_lo^T, big += a_hi b_hi^T (first: overwrite).
// A's hi and lo parts in registers (wgmma_m64n128k8_rs's layout), B's as
// qc::wgmma_desc descriptors of its two planes. NACC: 64 (N = 128) or 32
// (N = 64) accumulators a thread.
template <int NACC>
__device__ __forceinline__ void mma_step(float (&big)[NACC], float (&small)[NACC],
                                         const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                         uint64_t b_hi, uint64_t b_lo, bool first) {
  wgmma_tf32(small, a_lo, b_hi, !first);
  wgmma_tf32(small, a_hi, b_lo, 1);
  wgmma_tf32(big, a_hi, b_hi, !first);
}

// This thread's A fragment of an 8-column K step `kk` from a 128-byte
// swizzled box of f32 at shared address `box` (row `row` and row + 8, the
// row's 16-byte chunks XORed with row % 8, as TMA lays them): columns
// 8 kk + t and 8 kk + t + 4.
__device__ __forceinline__ void load_a(float (&x)[4], uint32_t box, int row, int t, int kk) {
  const uint32_t r0 = box + row * 128, r1 = r0 + 8 * 128;
  const uint32_t c0 = (((2 * kk) ^ (row & 7)) << 4) + 4 * t;
  const uint32_t c1 = (((2 * kk + 1) ^ (row & 7)) << 4) + 4 * t;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[0]) : "r"(r0 + c0));
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[1]) : "r"(r1 + c0));
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[2]) : "r"(r0 + c1));
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[3]) : "r"(r1 + c1));
}

}  // namespace tf32x3
