// Non-causal attention forward with a key-padding mask, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _flash_fwd_impl).
//
// What it computes. q, k, v (B, H, T, Dh) in bf16, fp16 or f32, mask (B, T)
// f32 with 1 = real key; T at most 128 or a multiple of 64, Dh one of 16,
// 32, 64, 128, 256 (the wrapper pads other head widths up to 256 with zero
// columns) or a multiple of 8 above 256 (the wide path at the end).
// Scores s = (q.k) / sqrt(Dh) in f32; a masked key scores the finite -1e30
// (not -inf), so a query whose keys are all masked gets the mean of V, as
// the TPU kernel and the plain reference do. Online softmax over KV blocks
// with the (m, l, acc) recurrence in f32; out = acc / max(l, 1e-30),
// written in q's dtype.
//
// What bounds it on this card. 4*B*H*T^2*Dh operations against 8*B*H*T*Dh
// bytes of q, k, v and o: T/2 operations per byte. At the encoder's T = 64
// to 256 that is below the ~295 FLOP/byte ridge, so it is bound by memory
// at T <= ~512 and by the tensor cores above (T = 1024 under "auto"). On
// the card it takes 3.6x that bound at the serve shape; neither a CTA's
// start-up nor the latency of its loads is what holds it (PERF.md §7).
//
// What the design does about it (the FlashAttention-2 form):
//  * One CTA per (b, 128 query rows, a group of heads) (64 rows where T is
//    not a multiple of 128), one warp per 16 query rows. The CTA takes its
//    heads in turn, as many as leave 2,048 CTAs: at the encoder's short
//    lengths a head is a few key blocks, and a CTA per head would spend
//    more time starting than multiplying. K and V stream once per CTA and
//    head through a three-stage cp.async ring of 64-key blocks (the next
//    head's Q tile with its first block), two blocks' copies in flight
//    under the current block's products, one barrier a block; the (T, T)
//    score matrix never exists outside registers.
//  * Both products run on mma.sync m16n8k16 (f32 accumulation) with
//    operands from shared memory by ldmatrix (V transposed on the way).
//    Q's fragments are loaded once a head. S, the running (m, l), P and O
//    live in registers: the C fragment of Q K^T, rounded to the input dtype
//    (as FlashAttention does; l sums the unrounded f32 p), is the A fragment
//    of P V, and a row's maximum and sum take two quad shuffles.
//    Exponentials are exp2 of scores prescaled by log2(e).
//  * A key block in which the mask holds no real key is skipped for every
//    batch row that has a real key: there its p = exp(-1e30 - m) is 0 and
//    its alpha 1 (or, before the row's first real block, the row's l and
//    acc are multiplied by exactly 0 at that block), so skipping leaves l
//    and acc unchanged bit for bit. A batch row with no real key runs every
//    block (the mean of V). The CTA finds its live blocks from the mask
//    row while its first Q tile is in flight.
//  * q, k, v and o are read and written through their (B, H, T) strides,
//    the head dimension contiguous: the encoder's (B, T, H, Dh) views need
//    no copy on the way in, nor the output on the way out. Rows move as
//    16-byte vectors (the wrapper checks the alignment); O goes out through
//    the warp's rows of the Q tile in shared memory.
//  * A T that is not a multiple of 64 (T < 128 only) runs the TAIL
//    instantiation: 64 query rows a CTA, the last key and query block loaded
//    with zero fill (cp.async with 0 source bytes, no read past the rows),
//    keys at or past T scored -inf (p = 0 exactly, even in a row whose keys
//    are all masked, which averages V over its T keys only), the mask read a
//    key at a time, query rows at or past T never stored. T a multiple of 64
//    runs the code it ran before, bit for bit.
//
// The f32 path (flash_f32_kernel): the JAX kernel computes in f32 whatever
// its input, and an f32 encoder is held to 2e-5 of the plain f32 attention;
// bf16 P and tensor-core TF32 would miss that. So both products are f32
// FMA chains on the CUDA cores. One CTA of 256 threads per (b, h, 64 query
// rows), the live key blocks of 64 in turn: S = Q K^T by 4 x 4 register
// micro-tiles (Dh in float4 steps) into shared memory, the online softmax by
// four threads a row, then O += P V by 4 x Dh/16 micro-tiles kept in
// registers across blocks. Dead key blocks are skipped as above; masked keys,
// tails and all-masked rows follow the same rules. Bound by f32 FMAs (67
// TFLOP/s) from about T = 256; not yet pipelined.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int BKV = 64;  // keys per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* o;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  int H, Tlen, nqb, hg;  // hg: heads a CTA takes in turn
  float scale_log2;  // log2(e) / sqrt(Dh)
};

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma<__half> {
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
// 16 bytes, or 16 zero bytes when !valid (0 source bytes: nothing is read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory: NST Q tiles (bq rows each, by head), NST stages of K and V
// (64 rows each) and of the mask (64 f32), per key block a flag and the list
// of live blocks (T/64 ints each). Rows are Dh + 8 elements apart, so the
// eight 16-byte rows an ldmatrix reads fall on different banks. Ring stages:
// three (two blocks' copies in flight under one's products) up to Dh = 128;
// two at Dh = 256, where three would not fit.
__host__ __device__ constexpr int ring_stages(int dh) { return dh <= 128 ? 3 : 2; }
__host__ __device__ constexpr int row_ld(int dh) { return dh + 8; }
__host__ __device__ inline size_t smem_bytes(int dh, int bq, int nkb) {
  const int nst = ring_stages(dh);
  return (size_t)nst * (bq + 2 * BKV) * row_ld(dh) * 2 + nst * BKV * 4 + (size_t)nkb * 8;
}

// TAIL: T is not a multiple of 64 (then below 128, NW = 4): zero-filled
// tail rows, keys at or past T at -inf, the mask read a key at a time.
// Dh = 256 keeps Q's fragments in shared memory and loads them a key block
// at a time: in registers they would take 64 more a thread beside O's 128.
template <int DH, typename T, int NW, bool TAIL>
__global__ void __launch_bounds__(NW * 32) flash_fwd_kernel(const Args a) {
  constexpr int BQ = NW * 16, LD = row_ld(DH), CH = DH / 8, NT = NW * 32;
  constexpr int NST = ring_stages(DH);
  constexpr bool Q_IN_REGS = DH <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [NST][BQ][LD], head hi in hi % NST
  T* k_s = q_s + NST * BQ * LD;         // [NST][BKV][LD]
  T* v_s = k_s + NST * BKV * LD;        // [NST][BKV][LD]
  float* m_s = reinterpret_cast<float*>(v_s + NST * BKV * LD);  // [NST][BKV]
  int* live = reinterpret_cast<int*>(m_s + NST * BKV);          // [nkb], then flags [nkb]
  __shared__ int n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  const int nkb = (a.Tlen + BKV - 1) / BKV;
  int bid = blockIdx.x;
  const int qb = bid % a.nqb;
  bid /= a.nqb;
  const int nhg = a.H / a.hg;
  const int h0 = (bid % nhg) * a.hg, b = bid / nhg;  // heads h0 .. h0 + hg - 1
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h0 * a.q_sh + (long long)qb * BQ * a.q_st;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h0 * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h0 * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h0 * a.o_sh + ((long long)qb * BQ + warp * 16) * a.o_st;
  const float* mp = a.mask + (long long)b * a.Tlen;

  auto load_q = [&](int hi) {  // the Q tile of head h0 + hi
    T* qs = q_s + (hi % NST) * BQ * LD;
    const T* src = qp + hi * a.q_sh;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      if (TAIL)
        cp_async16_zfill(qs + r * LD + c, src + r * a.q_st + c, qb * BQ + r < a.Tlen);
      else
        cp_async16(qs + r * LD + c, src + r * a.q_st + c);
    }
  };
  // the Q tile of head h0 starts on its way while the mask is read
  load_q(0);

  // the key blocks that hold a real key, in order; all of them if none does
  int* flag = live + nkb;
  for (int j = warp; j < nkb; j += NW) {
    const int k0 = j * BKV + lane, k1 = k0 + 32;
    const bool any = TAIL ? __any_sync(0xffffffffu, (k0 < a.Tlen && mp[k0] > 0.0f) ||
                                                        (k1 < a.Tlen && mp[k1] > 0.0f))
                          : __any_sync(0xffffffffu, mp[k0] > 0.0f || mp[k1] > 0.0f);
    if (lane == 0) flag[j] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nkb; base += 32) {
      const bool f = base + lane < nkb && flag[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      if (f) live[n + __popc(ballot & ((1u << lane) - 1))] = base + lane;
      n += __popc(ballot);
    }
    if (n == 0) {
      for (int j = lane; j < nkb; j += 32) live[j] = j;
      n = nkb;
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int nl = n_live, n_items = nl * a.hg;

  // item it: head h0 + it / nl, its (it % nl)-th live key block, into stage
  // it % NST with the head's Q tile if it is the head's first block
  auto load_item = [&](int it) {
    const int hi = it / nl, kb = live[it % nl], stage = it % NST;
    if (it % nl == 0 && hi > 0) load_q(hi);
    T* ks = k_s + stage * BKV * LD;
    T* vs = v_s + stage * BKV * LD;
    const T* ksrc = kp + hi * a.k_sh;
    const T* vsrc = vp + hi * a.v_sh;
    for (int i = tid; i < BKV * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const long long row = (long long)kb * BKV + r;
      if (TAIL) {
        cp_async16_zfill(ks + r * LD + c, ksrc + row * a.k_st + c, row < a.Tlen);
        cp_async16_zfill(vs + r * LD + c, vsrc + row * a.v_st + c, row < a.Tlen);
      } else {
        cp_async16(ks + r * LD + c, ksrc + row * a.k_st + c);
        cp_async16(vs + r * LD + c, vsrc + row * a.v_st + c);
      }
    }
    if (TAIL) {
      // read by every thread two barriers on; keys past T are -inf below
      if (tid < BKV) m_s[stage * BKV + tid] = kb * BKV + tid < a.Tlen ? mp[kb * BKV + tid] : 0.0f;
    } else if (tid < BKV / 4) {
      cp_async16(m_s + stage * BKV + tid * 4, mp + kb * BKV + tid * 4);
    }
  };
  // one commit group per item (empty past the last), the first with Q
  for (int it = 0; it < NST - 1; ++it) {
    if (it < n_items) load_item(it);
    cp_async_commit();
  }

  uint32_t qa[Q_IN_REGS ? DH / 16 : 1][4];  // Q's A fragments, this warp's 16 rows
  float o[DH / 8][4];       // O: rows g and g + 8, columns 8d + 2tg + {0, 1}
  float m0 = NEG_INF, m1 = NEG_INF;  // running maxima of rows g, g + 8 (log2 units)
  float l0 = 0.0f, l1 = 0.0f;        // this thread's part of the running sums

  // one head's blocks, then the next head's; NST - 1 items' copies in flight
  for (int i = 0, hi = 0, j = 0; i < n_items; ++i) {
    cp_async_wait<NST - 2>();  // item i has landed
    __syncthreads();           // ... for every thread; and item i - 1's stage is free
    if (i + NST - 1 < n_items) load_item(i + NST - 1);
    cp_async_commit();
    T* qs = q_s + (hi % NST) * BQ * LD;
    if (j == 0) {  // a new head: its Q fragments, fresh statistics
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.0f;
    }
    const T* ks = k_s + (i % NST) * BKV * LD;
    const T* vs = v_s + (i % NST) * BKV * LD;
    const float* ms = m_s + (i % NST) * BKV;

    // S (16 x 64) = Q K^T: n-tile jj holds keys 8jj..8jj+7
    float s[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int qk = Q_IN_REGS ? kk : 0;
      if constexpr (!Q_IN_REGS)
        ldsm_x4(qa[0], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        Mma<T>::run(s[2 * np], qa[qk], bb[0], bb[1]);
        Mma<T>::run(s[2 * np + 1], qa[qk], bb[2], bb[3]);
      }
    }

    // online softmax in the registers
    float mx0 = NEG_INF, mx1 = NEG_INF;
    const int key0 = TAIL ? live[j] * BKV + 2 * tg : 0;  // this thread's first key
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 mk = *reinterpret_cast<const float2*>(ms + 8 * jj + 2 * tg);
      s[jj][0] = mk.x > 0.0f ? s[jj][0] * a.scale_log2 : NEG_INF;
      s[jj][1] = mk.y > 0.0f ? s[jj][1] * a.scale_log2 : NEG_INF;
      s[jj][2] = mk.x > 0.0f ? s[jj][2] * a.scale_log2 : NEG_INF;
      s[jj][3] = mk.y > 0.0f ? s[jj][3] * a.scale_log2 : NEG_INF;
      if (TAIL) {  // no key at all: p = 0 whatever the row's maximum
        if (key0 + 8 * jj >= a.Tlen) s[jj][0] = s[jj][2] = -INFINITY;
        if (key0 + 8 * jj + 1 >= a.Tlen) s[jj][1] = s[jj][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[4][4];  // P's A fragments, one per 16-key step
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p0 = exp2f(s[jj][0] - mn0), p1 = exp2f(s[jj][1] - mn0);
      const float p2 = exp2f(s[jj][2] - mn1), p3 = exp2f(s[jj][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[jj >> 1][(jj & 1) * 2] = Mma<T>::pack(p0, p1);
      pa[jj >> 1][(jj & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      o[d][0] *= al0;
      o[d][1] *= al0;
      o[d][2] *= al1;
      o[d][3] *= al1;
    }

    // O (16 x DH) += P (16 x 64) V (64 x DH)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                              (lane >> 4) * 8);
        Mma<T>::run(o[2 * dp], pa[kk], bb[0], bb[1]);
        Mma<T>::run(o[2 * dp + 1], pa[kk], bb[2], bb[3]);
      }
    }

    if (j + 1 == nl) {  // the head's last block: out = acc / l
      const float t0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1);
      const float t1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
      const float inv0 = 1.0f / fmaxf(t0 + __shfl_xor_sync(0xffffffffu, t0, 2), 1e-30f);
      const float inv1 = 1.0f / fmaxf(t1 + __shfl_xor_sync(0xffffffffu, t1, 2), 1e-30f);
      // the warp read its Q fragments from its own rows of this head's Q
      // tile, which now stage its output (the tile is refilled NST heads on,
      // after a barrier)
      T* os = qs + warp * 16 * LD;
      __syncwarp();
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        *reinterpret_cast<uint32_t*>(os + g * LD + 8 * d + 2 * tg) =
            Mma<T>::pack(o[d][0] * inv0, o[d][1] * inv0);
        *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * d + 2 * tg) =
            Mma<T>::pack(o[d][2] * inv1, o[d][3] * inv1);
      }
      __syncwarp();
      T* dst = op + hi * a.o_sh;
      for (int e = lane; e < 16 * CH; e += 32) {
        const int r = e / CH, c = (e % CH) * 8;
        if (TAIL && qb * BQ + warp * 16 + r >= a.Tlen) continue;
        *reinterpret_cast<uint4*>(dst + r * a.o_st + c) =
            *reinterpret_cast<const uint4*>(os + r * LD + c);
      }
    }
    if (++j == nl) {
      j = 0;
      ++hi;
    }
  }
}

// Heads a CTA takes in turn: the most that still leaves 2,048 CTAs (several
// waves on 132 SMs), so short sequences stream one head's K and V under the
// previous head's products instead of paying a CTA's start-up for each.
inline int heads_per_cta(int H, long long ctas_per_head) {
  for (int hg = H; hg > 1; --hg)
    if (H % hg == 0 && ctas_per_head * (H / hg) >= 2048) return hg;
  return 1;
}

template <int DH, typename T, int NW, bool TAIL>
int launch(Args a, int B, cudaStream_t st) {
  constexpr int BQ = NW * 16;
  a.nqb = (a.Tlen + BQ - 1) / BQ;
  a.hg = heads_per_cta(a.H, (long long)B * a.nqb);
  const size_t smem = smem_bytes(DH, BQ, (a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * (a.H / a.hg) * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH, T, NW, TAIL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<DH, T, NW, TAIL><<<(unsigned)grid, NW * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int dispatch_rows(const Args& a, int B, cudaStream_t st) {
  // 128 query rows a CTA (8 warps) where T allows it, else 64 (4 warps);
  // a T that is not a multiple of 64 (below 128) on the tail instantiation.
  // Dh = 256 always takes 64 rows: 128 would not fit shared memory.
  if (a.Tlen % BKV) return launch<DH, T, 4, true>(a, B, st);
  if constexpr (DH <= 128)
    if (a.Tlen % 128 == 0) return launch<DH, T, 8, false>(a, B, st);
  return launch<DH, T, 4, false>(a, B, st);
}

// ------------------------------------------------------------- f32 path

constexpr int F32_BQ = 64;        // query rows a CTA
constexpr int F32_THREADS = 256;  // 16 x 16
constexpr int F32_SLD = BKV + 4;  // row stride of the S / P tile

__host__ __device__ constexpr int f32_ld(int dh) { return dh + 4; }
__host__ __device__ inline size_t f32_smem_bytes(int dh, int nkb) {
  return (size_t)(F32_BQ + 2 * BKV) * f32_ld(dh) * 4 + (size_t)F32_BQ * F32_SLD * 4 +
         (size_t)(BKV + 2 * F32_BQ) * 4 + (size_t)nkb * 8;
}

template <int DH>
__global__ void __launch_bounds__(F32_THREADS) flash_f32_kernel(const Args a) {
  constexpr int LD = f32_ld(DH), C4 = DH / 4, CPT = DH / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [F32_BQ][LD]
  float* k_s = q_s + F32_BQ * LD;               // [BKV][LD]
  float* v_s = k_s + BKV * LD;                  // [BKV][LD]
  float* p_s = v_s + BKV * LD;                  // [F32_BQ][F32_SLD]: S, then P
  float* m_s = p_s + F32_BQ * F32_SLD;          // [BKV] the block's mask
  float* al_s = m_s + BKV;                      // [F32_BQ] each row's alpha
  float* l_s = al_s + F32_BQ;                   // [F32_BQ] each row's sum, at the end
  int* live = reinterpret_cast<int*>(l_s + F32_BQ);  // [nkb], then flags [nkb]
  __shared__ int n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid & 15, ty = tid >> 4;
  const int Tlen = a.Tlen;
  const int nkb = (Tlen + BKV - 1) / BKV;
  int bid = blockIdx.x;
  const int qb = bid % a.nqb;
  bid /= a.nqb;
  const int h = bid % a.H, b = bid / a.H;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* mp = a.mask + (long long)b * Tlen;
  const int row_base = qb * F32_BQ;

  // the Q tile (zero rows past T) goes out while the mask is read
  for (int i = tid; i < F32_BQ * C4; i += F32_THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const long long row = row_base + r;
    cp_async16_zfill(q_s + r * LD + c, qp + (row < Tlen ? row : 0) * a.q_st + c, row < Tlen);
  }
  cp_async_commit();

  // the key blocks that hold a real key, in order; all of them if none does
  int* flag = live + nkb;
  for (int j = warp; j < nkb; j += F32_THREADS / 32) {
    const int k0 = j * BKV + lane, k1 = k0 + 32;
    const bool any = __any_sync(0xffffffffu, (k0 < Tlen && mp[k0] > 0.0f) ||
                                                 (k1 < Tlen && mp[k1] > 0.0f));
    if (lane == 0) flag[j] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nkb; base += 32) {
      const bool f = base + lane < nkb && flag[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      if (f) live[n + __popc(ballot & ((1u << lane) - 1))] = base + lane;
      n += __popc(ballot);
    }
    if (n == 0) {
      for (int j = lane; j < nkb; j += 32) live[j] = j;
      n = nkb;
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int nl = n_live;

  // the softmax's row and quarter of the block (four threads a row, adjacent lanes)
  const int srow = tid >> 2, part = tid & 3;
  float m_run = NEG_INF, l_run = 0.0f;
  float o[4][CPT];  // rows ty + 16i, columns tx + 16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.0f;

  for (int j = 0; j < nl; ++j) {
    const int kb = live[j];
    for (int i = tid; i < BKV * C4; i += F32_THREADS) {
      const int r = i / C4, c = (i % C4) * 4;
      const long long row = (long long)kb * BKV + r;
      const long long src = row < Tlen ? row : 0;
      cp_async16_zfill(k_s + r * LD + c, kp + src * a.k_st + c, row < Tlen);
      cp_async16_zfill(v_s + r * LD + c, vp + src * a.v_st + c, row < Tlen);
    }
    cp_async_commit();
    if (tid < BKV) m_s[tid] = kb * BKV + tid < Tlen ? mp[kb * BKV + tid] : 0.0f;
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T, one f32 chain over Dh per score: rows ty + 16i, keys tx + 16jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * jj) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = tx + 16 * jj;
      const bool real = m_s[key] > 0.0f, past = kb * BKV + key >= Tlen;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p_s[(ty + 16 * i) * F32_SLD + key] =
            past ? -INFINITY : (real ? s[i][jj] * a.scale_log2 : NEG_INF);
    }
    __syncthreads();

    // online softmax: four threads a row, sixteen keys each
    {
      float* pr = p_s + srow * F32_SLD + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, pr[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run, mx);
      const float al = exp2f(m_run - mn);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = exp2f(pr[e] - mn);
        pr[e] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * al + sum;
      m_run = mn;
      if (part == 0) al_s[srow] = al;
    }
    __syncthreads();

    // O = O * alpha + P V: rows ty + 16i, columns tx + 16c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = al_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= al;
    }
#pragma unroll 2
    for (int key = 0; key < BKV; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * F32_SLD + key);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float v0 = v_s[(key + 0) * LD + tx + 16 * c];
        const float v1 = v_s[(key + 1) * LD + tx + 16 * c];
        const float v2 = v_s[(key + 2) * LD + tx + 16 * c];
        const float v3 = v_s[(key + 3) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c] = fmaf(pv[i].x, v0, o[i][c]);
          o[i][c] = fmaf(pv[i].y, v1, o[i][c]);
          o[i][c] = fmaf(pv[i].z, v2, o[i][c]);
          o[i][c] = fmaf(pv[i].w, v3, o[i][c]);
        }
      }
    }
    __syncthreads();  // K, V, S and alpha are rewritten by the next block
  }

  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row_base + r >= Tlen) continue;
    const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
    float* dst = op + (long long)(row_base + r) * a.o_st;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dst[tx + 16 * c] = o[i][c] * inv;
  }
}

template <int DH>
int launch_f32(Args a, int B, cudaStream_t st) {
  a.nqb = (a.Tlen + F32_BQ - 1) / F32_BQ;
  a.hg = 1;
  const size_t smem = f32_smem_bytes(DH, (a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * a.H * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_f32_kernel<DH><<<(unsigned)grid, F32_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- wide heads

// Head widths past 256 (any multiple of 8), every input type: f32 FMAs on
// values widened as they are loaded, one CTA of 256 threads per (b, h, 64
// query rows, 128 columns of V and O). For each live key block the CTA takes
// S = Q K^T over the whole of Dh, 128 columns of Q and K at a time staged in
// shared memory (so Q is read again per key block: these widths are rare and
// this path is about taking them at all), then the online softmax and
// O += P V on its own 128 columns of V, as in the f32 path; masks, tails and
// dead blocks follow the same rules. The CTAs of one (b, h, rows) compute
// the same S and differ only in the columns of V they read and of O they
// write. Bound by f32 FMAs (4 B H T^2 Dh at 67 TFLOP/s, and S once more per
// column group).
constexpr int WIDE_COLS = 128;            // columns of a Q, K or V chunk
constexpr int WIDE_LD = WIDE_COLS + 4;    // their row stride in shared memory

__host__ __device__ inline size_t wide_smem_bytes(int nkb) {
  return (size_t)(F32_BQ + BKV) * WIDE_LD * 4 + (size_t)F32_BQ * F32_SLD * 4 +
         (size_t)(BKV + 2 * F32_BQ) * 4 + (size_t)nkb * 8;
}

// four consecutive elements as f32 (the row is 16-byte aligned, the column a
// multiple of 4)
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4_f32(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_f32(__half* p, float v) { *p = __float2half(v); }

// rows row0..row0+63 of x (zero at or past Tlen), columns c0..c0+127 (zero
// at or past dh), as f32 into dst [64][WIDE_LD]
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* x, long long st, long long row0,
                                           int Tlen, int c0, int dh) {
  for (int i = threadIdx.x; i < BKV * WIDE_COLS / 4; i += F32_THREADS) {
    const int r = i / (WIDE_COLS / 4), c = (i % (WIDE_COLS / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < Tlen && c0 + c < dh) v = load4_f32(x + (row0 + r) * st + c0 + c);
    *reinterpret_cast<float4*>(dst + r * WIDE_LD + c) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(F32_THREADS) flash_wide_kernel(const Args a, int dh, int ncg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [F32_BQ][WIDE_LD]: a chunk of Q
  float* kv_s = q_s + F32_BQ * WIDE_LD;         // [BKV][WIDE_LD]: a chunk of K, then of V
  float* p_s = kv_s + BKV * WIDE_LD;            // [F32_BQ][F32_SLD]: S, then P
  float* m_s = p_s + F32_BQ * F32_SLD;          // [BKV] the block's mask
  float* al_s = m_s + BKV;                      // [F32_BQ] each row's alpha
  float* l_s = al_s + F32_BQ;                   // [F32_BQ] each row's sum, at the end
  int* live = reinterpret_cast<int*>(l_s + F32_BQ);  // [nkb], then flags [nkb]
  __shared__ int n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid & 15, ty = tid >> 4;
  const int Tlen = a.Tlen;
  const int nkb = (Tlen + BKV - 1) / BKV;
  int bid = blockIdx.x;
  const int qb = bid % a.nqb;
  bid /= a.nqb;
  const int cg = bid % ncg;
  bid /= ncg;
  const int h = bid % a.H, b = bid / a.H;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* mp = a.mask + (long long)b * Tlen;
  const int row_base = qb * F32_BQ, col0 = cg * WIDE_COLS;

  // the key blocks that hold a real key, in order; all of them if none does
  int* flag = live + nkb;
  for (int j = warp; j < nkb; j += F32_THREADS / 32) {
    const int k0 = j * BKV + lane, k1 = k0 + 32;
    const bool any = __any_sync(0xffffffffu, (k0 < Tlen && mp[k0] > 0.0f) ||
                                                 (k1 < Tlen && mp[k1] > 0.0f));
    if (lane == 0) flag[j] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nkb; base += 32) {
      const bool f = base + lane < nkb && flag[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      if (f) live[n + __popc(ballot & ((1u << lane) - 1))] = base + lane;
      n += __popc(ballot);
    }
    if (n == 0) {
      for (int j = lane; j < nkb; j += 32) live[j] = j;
      n = nkb;
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int nl = n_live;

  const int srow = tid >> 2, part = tid & 3;
  float m_run = NEG_INF, l_run = 0.0f;
  float o[4][WIDE_COLS / 16];  // rows ty + 16i, columns col0 + tx + 16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < WIDE_COLS / 16; ++c) o[i][c] = 0.0f;

  for (int j = 0; j < nl; ++j) {
    const int kb = live[j];
    if (tid < BKV) m_s[tid] = kb * BKV + tid < Tlen ? mp[kb * BKV + tid] : 0.0f;
    // S = Q K^T over the whole of Dh, one f32 chain per score in column order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
    for (int c0 = 0; c0 < dh; c0 += WIDE_COLS) {
      load_chunk(q_s, qp, a.q_st, row_base, Tlen, c0, dh);
      load_chunk(kv_s, kp, a.k_st, (long long)kb * BKV, Tlen, c0, dh);
      __syncthreads();
      const int cols = dh - c0 < WIDE_COLS ? dh - c0 : WIDE_COLS;
#pragma unroll 4
      for (int d = 0; d < cols; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * WIDE_LD + d);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * jj) * WIDE_LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
          }
      }
      __syncthreads();  // the chunks are rewritten next
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = tx + 16 * jj;
      const bool real = m_s[key] > 0.0f, past = kb * BKV + key >= Tlen;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p_s[(ty + 16 * i) * F32_SLD + key] =
            past ? -INFINITY : (real ? s[i][jj] * a.scale_log2 : NEG_INF);
    }
    // this CTA's columns of the block's V go in while the softmax runs
    load_chunk(kv_s, vp, a.v_st, (long long)kb * BKV, Tlen, col0, dh);
    __syncthreads();

    // online softmax: four threads a row, sixteen keys each
    {
      float* pr = p_s + srow * F32_SLD + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, pr[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run, mx);
      const float al = exp2f(m_run - mn);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = exp2f(pr[e] - mn);
        pr[e] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * al + sum;
      m_run = mn;
      if (part == 0) al_s[srow] = al;
    }
    __syncthreads();

    // O = O * alpha + P V on this CTA's columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = al_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < WIDE_COLS / 16; ++c) o[i][c] *= al;
    }
#pragma unroll 2
    for (int key = 0; key < BKV; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * F32_SLD + key);
#pragma unroll
      for (int c = 0; c < WIDE_COLS / 16; ++c) {
        const float v0 = kv_s[(key + 0) * WIDE_LD + tx + 16 * c];
        const float v1 = kv_s[(key + 1) * WIDE_LD + tx + 16 * c];
        const float v2 = kv_s[(key + 2) * WIDE_LD + tx + 16 * c];
        const float v3 = kv_s[(key + 3) * WIDE_LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][c] = fmaf(pv[i].x, v0, o[i][c]);
          o[i][c] = fmaf(pv[i].y, v1, o[i][c]);
          o[i][c] = fmaf(pv[i].z, v2, o[i][c]);
          o[i][c] = fmaf(pv[i].w, v3, o[i][c]);
        }
      }
    }
    __syncthreads();  // V, S, the mask and alpha are rewritten by the next block
  }

  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row_base + r >= Tlen) continue;
    const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
    T* dst = op + (long long)(row_base + r) * a.o_st;
#pragma unroll
    for (int c = 0; c < WIDE_COLS / 16; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < dh) store_f32(dst + col, o[i][c] * inv);
    }
  }
}

template <typename T>
int launch_wide(Args a, int B, int dh, cudaStream_t st) {
  a.nqb = (a.Tlen + F32_BQ - 1) / F32_BQ;
  a.hg = 1;
  const int ncg = (dh + WIDE_COLS - 1) / WIDE_COLS;
  const size_t smem = wide_smem_bytes((a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * ncg * a.H * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wide_kernel<T><<<(unsigned)grid, F32_THREADS, smem, st>>>(a, dh, ncg);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Args& a, int B, int Dh, cudaStream_t st) {
  if (Dh > 256) return launch_wide<float>(a, B, Dh, st);
  switch (Dh) {
    case 16: return launch_f32<16>(a, B, st);
    case 32: return launch_f32<32>(a, B, st);
    case 64: return launch_f32<64>(a, B, st);
    case 128: return launch_f32<128>(a, B, st);
    case 256: return launch_f32<256>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dh(const Args& a, int B, int Dh, cudaStream_t st) {
  if (Dh > 256) return launch_wide<T>(a, B, Dh, st);
  switch (Dh) {
    case 16: return dispatch_rows<16, T>(a, B, st);
    case 32: return dispatch_rows<32, T>(a, B, st);
    case 64: return dispatch_rows<64, T>(a, B, st);
    case 128: return dispatch_rows<128, T>(a, B, st);
    case 256: return dispatch_rows<256, T>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16, 2 = float32. T at most 128 or a multiple
// of 64; Dh one of 16, 32, 64, 128, 256, or a multiple of 8 above 256.
// strides: 12 element strides, (b, h, t) of q, k, v and o in that order;
// the head dimension is contiguous. Every base pointer must be 16-byte
// aligned and every stride a multiple of 16 bytes; the mask is a contiguous (B, T) f32 array, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int Tlen, int Dh,
                                   const long long* strides, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Tlen <= 0 || (Tlen > 128 && Tlen % BKV) || (Dh > 256 && Dh % 8))
    return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                    reinterpret_cast<uintptr_t>(mask);
  if (align % 16) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 2 ? 4 : 8;  // elements in 16 bytes
  for (int i = 0; i < 12; ++i)
    if (strides[i] % vec) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.o = o;
  a.q_sb = strides[0], a.q_sh = strides[1], a.q_st = strides[2];
  a.k_sb = strides[3], a.k_sh = strides[4], a.k_st = strides[5];
  a.v_sb = strides[6], a.v_sh = strides[7], a.v_st = strides[8];
  a.o_sb = strides[9], a.o_sh = strides[10], a.o_st = strides[11];
  a.H = H;
  a.Tlen = Tlen;
  a.nqb = a.hg = 0;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<__nv_bfloat16>(a, B, Dh, st);
  if (dtype == 1) return dispatch_dh<__half>(a, B, Dh, st);
  if (dtype == 2) return dispatch_f32(a, B, Dh, st);
  return (int)cudaErrorInvalidValue;
}
