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
//  * Packed texts (the VARLEN instantiation of both kernels, entry point
//    flash_attention_varlen_fwd): the encoder's inference forward runs on
//    its texts' real tokens end to end, q, k, v and o (N, H, Dh), with
//    cu (rows + 1) int32 offsets of the texts. A CTA takes a tile of 64
//    consecutive tokens, which may span several short texts, from a table
//    the host builds (ops/flash_attention.py::varlen_tiles: a text longer
//    than a tile gets tiles of its own, as T does in the padded kernel).
//    Its keys are the span of the texts its rows belong to, streamed from
//    the span's first key in 64-key blocks (zero fill past its end, so
//    every byte read is a real token's); a row scores -inf (p = 0 exactly)
//    at every key outside its own text, whose bounds each thread finds for
//    its two rows by a binary search in cu. No mask, no dead blocks: each
//    block holds some row's keys. Rows past the tile are zero-filled and
//    never stored, as in TAIL.
//  * Packed texts of a causal language model (the LM instantiation, entry
//    point flash_attention_varlen_lm_fwd; replaces no TPU kernel: the
//    LFM2-MoE encoder is the port's own). The VARLEN kernel with two
//    changes: a row's keys end at the row itself, so a tile's key span
//    ends at its last row and the blocks past it are never loaded; and K
//    and V hold fewer heads than Q (grouped-query attention), query head h
//    reading K/V head h / kv_group, so a K/V block is read once for each
//    query head of its group, from L2 after the first. Bound as VARLEN is:
//    by the bytes of q, k, v and o at the encoder's lengths.
//
// The f32 path (flash_tf32_kernel): the JAX kernel computes in f32 whatever
// its input, and an f32 encoder is held to 2e-5 of the plain f32 attention;
// bf16 P or one TF32 product (2^-11) would miss that. So both products run
// on the TF32 tensor cores by the 3xTF32 split of tf32x3.cuh, in the
// register form above: mma.sync m16n8k8 (TF32, f32 accumulation), one warp
// per 16 query rows, 64 rows a CTA, S, P, the running (m, l) and O in
// registers. An operand is split as its fragment is loaded, never in
// shared memory: it goes in raw as its own hi part (the tensor cores
// truncate it to TF32) beside lo = x - trunc(x), and each product is three,
// a_lo b_hi + a_hi b_lo + a_hi b_hi. An ldmatrix (b16) of rows of four f32
// gives both the A fragment of Q and the B fragment of K; V's B fragment
// (V transposed, which ldmatrix cannot do for 32-bit elements) is two
// scalar loads a step from rows Dh + 8 floats apart, on 32 different banks.
// S's n-tiles hold their keys permuted (C column 2t is key t, 2t + 1 is key
// t + 4), so the C fragment of S is P's A fragment as it stands. S keeps
// its small terms in an accumulator of their own until the softmax; O
// folds them into its own (at Dh = 256 O alone is 128 registers a thread):
// a product's rounding lands at 2^-23 of O, far inside the 2e-5. K and V
// blocks stream through a cp.async ring as items of their own (a block's V
// lands while its S is taken), Q tiles of the CTA's heads in turn beside
// them (one head at Dh = 256). Dead key blocks are skipped as above;
// masked keys, tails and all-masked rows follow the same rules. What holds
// it (PERF.md): at the serve shape the products and their splits take 60 %
// of the time and the rest (moving q, k, v and o) does not overlap them;
// mma.sync runs TF32 at about two thirds of wgmma's rate on this card.
//
// The wide path (flash_wide_kernel, head widths past 256) is described
// where it begins.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "tf32x3.cuh"

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
  // packed texts (VARLEN): the texts' token offsets, and per tile its
  // first row, its end, the text of its first row and one past its last's
  const int* cu;
  const int* tiles;
  // LM: query heads that share a K/V head (query head h reads K/V head
  // h / kv_group)
  int kv_group;
};

// A packed tile's rows [q0, q0 + q_rows) and keys [k0, k0 + k_len), and
// the keys [lo, hi) of one row's text counted from k0 (none past the
// tile): the text i of [first, last) with cu[i] <= r < cu[i + 1], by a
// binary search (an empty text repeats an offset and is passed over).
struct Tile {
  int q0, q_rows, k0, k_len;
  __device__ Tile(const Args& a, int t) {
    const int* e = a.tiles + 4 * t;
    q0 = e[0];
    q_rows = e[1] - e[0];
    k0 = a.cu[e[2]];
    k_len = a.cu[e[3]] - k0;
  }
  __device__ void row_keys(const Args& a, int t, int row, int& lo, int& hi) const {
    if (row >= q_rows) {
      lo = hi = 0;
      return;
    }
    int first = a.tiles[4 * t + 2], last = a.tiles[4 * t + 3];
    const int r = q0 + row;
    while (last - first > 1) {
      const int mid = (first + last) / 2;
      if (a.cu[mid] <= r)
        first = mid;
      else
        last = mid;
    }
    lo = a.cu[first] - k0;
    hi = a.cu[first + 1] - k0;
  }
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
// VARLEN (with TAIL, NW = 4): a packed tile (Tile), no mask.
// LM (with VARLEN): a causal language model's attention, as the LFM2-MoE
// encoder runs it: a row's keys end at the row itself (its text's keys up
// to its own place), so a tile's key span ends at its last row, and K and
// V have fewer heads than Q, query head h reading K/V head h / kv_group.
// Dh = 256 keeps Q's fragments in shared memory and loads them a key block
// at a time: in registers they would take 64 more a thread beside O's 128.
template <int DH, typename T, int NW, bool TAIL, bool VARLEN = false, bool LM = false>
__global__ void __launch_bounds__(NW * 32) flash_fwd_kernel(const Args a) {
  static_assert(!VARLEN || (TAIL && NW == 4), "a packed tile is 64 zero-filled rows");
  static_assert(!LM || VARLEN, "the causal grouped-K/V form runs on packed texts");
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
  // the CTA's rows [q0, q0 + q_rows) and keys [k_first, k_first + k_len):
  // its share of T and all of T, or a packed tile's; packed, the keys of
  // rows g and g + 8 of the warp's 16
  int q0 = qb * BQ, q_rows = a.Tlen - q0, k_first = 0, k_len = a.Tlen;
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  if constexpr (VARLEN) {
    const Tile tile(a, qb);
    q0 = tile.q0, q_rows = tile.q_rows, k_first = tile.k0, k_len = tile.k_len;
    tile.row_keys(a, qb, warp * 16 + g, lo0, hi0);
    tile.row_keys(a, qb, warp * 16 + g + 8, lo1, hi1);
    if constexpr (LM) {  // causal: no key past the row, none past the tile
      hi0 = min(hi0, q0 + warp * 16 + g + 1 - k_first);
      hi1 = min(hi1, q0 + warp * 16 + g + 9 - k_first);
      k_len = min(k_len, q0 + q_rows - k_first);
    }
  }
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h0 * a.q_sh + (long long)q0 * a.q_st;
  // LM: each head's K/V head is found where its blocks load (kv_head)
  const int kv_h0 = LM ? 0 : h0;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kv_h0 * a.k_sh + (long long)k_first * a.k_st;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kv_h0 * a.v_sh + (long long)k_first * a.v_st;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h0 * a.o_sh + ((long long)q0 + warp * 16) * a.o_st;
  const float* mp = a.mask + (long long)b * a.Tlen;

  auto load_q = [&](int hi) {  // the Q tile of head h0 + hi
    T* qs = q_s + (hi % NST) * BQ * LD;
    const T* src = qp + hi * a.q_sh;
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      if (TAIL)
        cp_async16_zfill(qs + r * LD + c, src + r * a.q_st + c, r < q_rows);
      else
        cp_async16(qs + r * LD + c, src + r * a.q_st + c);
    }
  };
  // the Q tile of head h0 starts on its way while the mask is read
  load_q(0);

  int nl;  // key blocks to run: packed, every block of the span
  if constexpr (VARLEN) {
    nl = (k_len + BKV - 1) / BKV;
  } else {
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
    nl = n_live;
  }
  const int n_items = nl * a.hg;

  // item it: head h0 + it / nl, its (it % nl)-th live key block, into stage
  // it % NST with the head's Q tile if it is the head's first block
  auto load_item = [&](int it) {
    const int hi = it / nl, kb = VARLEN ? it % nl : live[it % nl], stage = it % NST;
    if (it % nl == 0 && hi > 0) load_q(hi);
    T* ks = k_s + stage * BKV * LD;
    T* vs = v_s + stage * BKV * LD;
    const int kv_head = LM ? (h0 + hi) / a.kv_group : hi;
    const T* ksrc = kp + kv_head * a.k_sh;
    const T* vsrc = vp + kv_head * a.v_sh;
    for (int i = tid; i < BKV * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const long long row = (long long)kb * BKV + r;
      if (TAIL) {
        cp_async16_zfill(ks + r * LD + c, ksrc + row * a.k_st + c, row < k_len);
        cp_async16_zfill(vs + r * LD + c, vsrc + row * a.v_st + c, row < k_len);
      } else {
        cp_async16(ks + r * LD + c, ksrc + row * a.k_st + c);
        cp_async16(vs + r * LD + c, vsrc + row * a.v_st + c);
      }
    }
    if (VARLEN) return;
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
    // this thread's first key
    const int key0 = VARLEN ? j * BKV + 2 * tg : TAIL ? live[j] * BKV + 2 * tg : 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if constexpr (VARLEN) {  // a key of another text: p = 0 exactly
        const int k = key0 + 8 * jj;
        s[jj][0] = k >= lo0 && k < hi0 ? s[jj][0] * a.scale_log2 : -INFINITY;
        s[jj][1] = k + 1 >= lo0 && k + 1 < hi0 ? s[jj][1] * a.scale_log2 : -INFINITY;
        s[jj][2] = k >= lo1 && k < hi1 ? s[jj][2] * a.scale_log2 : -INFINITY;
        s[jj][3] = k + 1 >= lo1 && k + 1 < hi1 ? s[jj][3] * a.scale_log2 : -INFINITY;
      } else {
        const float2 mk = *reinterpret_cast<const float2*>(ms + 8 * jj + 2 * tg);
        s[jj][0] = mk.x > 0.0f ? s[jj][0] * a.scale_log2 : NEG_INF;
        s[jj][1] = mk.y > 0.0f ? s[jj][1] * a.scale_log2 : NEG_INF;
        s[jj][2] = mk.x > 0.0f ? s[jj][2] * a.scale_log2 : NEG_INF;
        s[jj][3] = mk.y > 0.0f ? s[jj][3] * a.scale_log2 : NEG_INF;
        if (TAIL) {  // no key at all: p = 0 whatever the row's maximum
          if (key0 + 8 * jj >= a.Tlen) s[jj][0] = s[jj][2] = -INFINITY;
          if (key0 + 8 * jj + 1 >= a.Tlen) s[jj][1] = s[jj][3] = -INFINITY;
        }
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
        if (TAIL && warp * 16 + r >= q_rows) continue;
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

// Packed (VARLEN): B = 1, Tlen = 0, and a.nqb the caller's tiles.
template <int DH, typename T, int NW, bool TAIL, bool VARLEN = false, bool LM = false>
int launch(Args a, int B, cudaStream_t st) {
  constexpr int BQ = NW * 16;
  if (!VARLEN) a.nqb = (a.Tlen + BQ - 1) / BQ;
  a.hg = heads_per_cta(a.H, (long long)B * a.nqb);
  const size_t smem = smem_bytes(DH, BQ, (a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * (a.H / a.hg) * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH, T, NW, TAIL, VARLEN, LM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<DH, T, NW, TAIL, VARLEN, LM><<<(unsigned)grid, NW * 32, smem, st>>>(a);
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

// The key blocks that hold a real key, in order, into live[0 .. n) (every
// block if none does; live + nkb is scratch for a flag a block), n into
// *n_live and returned. Every thread of the CTA calls it; it ends on a
// barrier.
__device__ __forceinline__ int find_live_blocks(const float* mp, int Tlen, int* live,
                                                int* n_live) {
  const int nkb = (Tlen + BKV - 1) / BKV, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* flag = live + nkb;
  for (int j = warp; j < nkb; j += blockDim.x / 32) {
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
    if (lane == 0) *n_live = n;
  }
  __syncthreads();
  return *n_live;
}

// A ring stage holds one 64-key block, of K or of V: K's rows Dh + 4
// floats apart (the eight 16-byte rows of an ldmatrix on different banks),
// V's Dh + 8 (the 32 lanes' scalar B-fragment loads, rows t and columns g,
// on different banks). Three stages (a block's K and V in flight under the
// previous block's products) and two Q tiles (one head's in use, the next
// head's on its way) up to Dh = 128; at Dh = 256 one Q tile (64 KB) and two
// stages fill shared memory, and the CTA takes one head. Three CTAs of four
// warps an SM up to Dh = 64 (168 registers), one above. (128 rows a CTA,
// eight warps, was 1 % faster at the serve shape and a third slower at T =
// 1024, where it halves the CTAs: PERF.md.)
constexpr int TF_NW = 4, TF_BQ = TF_NW * 16;
__host__ __device__ constexpr int tf_ldk(int dh) { return dh + 4; }
__host__ __device__ constexpr int tf_ldv(int dh) { return dh + 8; }
__host__ __device__ constexpr int tf_stages(int dh) { return dh <= 128 ? 3 : 2; }
__host__ __device__ constexpr int tf_q_tiles(int dh) { return dh <= 128 ? 2 : 1; }
__host__ __device__ inline size_t tf_smem_bytes(int dh, int nkb) {
  return ((size_t)tf_q_tiles(dh) * TF_BQ * tf_ldk(dh) +
          (size_t)tf_stages(dh) * BKV * (tf_ldv(dh) + 1)) * 4 + (size_t)nkb * 8;
}
// the key that row r (0..7) of an 8-key n-tile of S stands for: C column
// 2t is key t and 2t + 1 is key t + 4, so a thread's C fragment of S is its
// A fragment of P V without a shuffle
__device__ __forceinline__ int key_perm(int r) { return (r >> 1) + (r & 1) * 4; }

// Q's rows at or past T (TAIL) are zero-filled and never stored; keys at
// or past T score -inf; the mask is read a key at a time. VARLEN (with
// TAIL): a packed tile (Tile), no mask.
template <int DH, bool TAIL, bool VARLEN = false>
__global__ void __launch_bounds__(TF_NW * 32, DH <= 64 ? 3 : 1) flash_tf32_kernel(const Args a) {
  static_assert(!VARLEN || TAIL, "a packed tile is zero-filled");
  constexpr int BQ = TF_BQ, NT = TF_NW * 32, LDK = tf_ldk(DH), LDV = tf_ldv(DH), C4 = DH / 4;
  constexpr int NST = tf_stages(DH), NQ = tf_q_tiles(DH);
  constexpr bool Q_IN_REGS = DH <= 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [NQ][BQ][LDK], head hi in hi % NQ
  float* t_s = q_s + NQ * BQ * LDK;             // [NST][BKV][LDV]: a K or a V block
  float* m_s = t_s + NST * BKV * LDV;           // [NST][BKV]: a K block's mask
  int* live = reinterpret_cast<int*>(m_s + NST * BKV);  // [nkb], then flags [nkb]
  __shared__ int n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  int bid = blockIdx.x;
  const int qb = bid % a.nqb;
  bid /= a.nqb;
  const int nhg = a.H / a.hg;
  const int h0 = (bid % nhg) * a.hg, b = bid / nhg;  // heads h0 .. h0 + hg - 1
  // rows, keys and (packed) the keys of rows g and g + 8, as in flash_fwd_kernel
  int q0 = qb * BQ, q_rows = a.Tlen - q0, k_first = 0, k_len = a.Tlen;
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  if constexpr (VARLEN) {
    const Tile tile(a, qb);
    q0 = tile.q0, q_rows = tile.q_rows, k_first = tile.k0, k_len = tile.k_len;
    tile.row_keys(a, qb, warp * 16 + g, lo0, hi0);
    tile.row_keys(a, qb, warp * 16 + g + 8, lo1, hi1);
  }
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h0 * a.q_sh +
                    (long long)q0 * a.q_st;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h0 * a.k_sh +
                    (long long)k_first * a.k_st;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h0 * a.v_sh +
                    (long long)k_first * a.v_st;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h0 * a.o_sh +
              ((long long)q0 + warp * 16) * a.o_st;
  const float* mp = a.mask + (long long)b * a.Tlen;

  auto load_q = [&](int hi) {  // the Q tile of head h0 + hi
    float* qs = q_s + (hi % NQ) * BQ * LDK;
    const float* src = qp + hi * a.q_sh;
    for (int i = tid; i < BQ * C4; i += NT) {
      const int r = i / C4, c = (i % C4) * 4;
      if (TAIL)
        cp_async16_zfill(qs + r * LDK + c, src + r * a.q_st + c, r < q_rows);
      else
        cp_async16(qs + r * LDK + c, src + r * a.q_st + c);
    }
  };
  load_q(0);  // on its way while the mask is read
  const int nl = VARLEN ? (k_len + BKV - 1) / BKV : find_live_blocks(mp, a.Tlen, live, &n_live);
  const int n_items = 2 * nl * a.hg;

  // item it: the K (it even) or V (odd) block of the CTA's (it / 2)-th
  // (head, live block), into stage it % NST; a head's first K block brings
  // the head's Q tile, and every K block its mask
  auto load_item = [&](int it) {
    const int blk = it >> 1, hi = blk / nl, kb = VARLEN ? blk % nl : live[blk % nl];
    const int stage = it % NST;
    const bool is_v = it & 1;
    if (!is_v && blk % nl == 0 && hi > 0) load_q(hi);
    float* ts = t_s + stage * BKV * LDV;
    const int ld = is_v ? LDV : LDK;
    const float* src = is_v ? vp + hi * a.v_sh : kp + hi * a.k_sh;
    const long long st = is_v ? a.v_st : a.k_st;
    for (int i = tid; i < BKV * C4; i += NT) {
      const int r = i / C4, c = (i % C4) * 4;
      const long long row = (long long)kb * BKV + r;
      if (TAIL)
        cp_async16_zfill(ts + r * ld + c, src + row * st + c, row < k_len);
      else
        cp_async16(ts + r * ld + c, src + row * st + c);
    }
    if (is_v || VARLEN) return;
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
  // item i has landed for every thread and item i - 1's stage is free;
  // item i + NST - 1 goes out
  auto next = [&](int i) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (i + NST - 1 < n_items) load_item(i + NST - 1);
    cp_async_commit();
  };

  uint32_t qa[Q_IN_REGS ? DH / 8 : 1][4];  // Q's raw A fragments, this warp's 16 rows
  float o[DH / 8][4];  // O: rows g and g + 8, columns 8d + 2tg + {0, 1}
  float m0 = NEG_INF, m1 = NEG_INF;  // running maxima of rows g, g + 8 (log2 units)
  float l0 = 0.0f, l1 = 0.0f;        // this thread's part of the running sums

  for (int blk = 0, hi = 0, j = 0; blk < nl * a.hg; ++blk) {
    next(2 * blk);
    const float* qs = q_s + (hi % NQ) * BQ * LDK + warp * 16 * LDK;  // the warp's rows
    const float* ks = t_s + (2 * blk % NST) * BKV * LDV;
    const float* ms = m_s + (2 * blk % NST) * BKV;
    if (j == 0) {  // a new head: its Q fragments, fresh statistics
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int kk = 0; kk < DH / 8; ++kk)
          ldsm_x4(qa[kk], qs + (lane & 15) * LDK + kk * 8 + (lane >> 4) * 4);
      }
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.0f;
    }

    // S (16 x 64) = Q K^T on 3xTF32, the small terms in their own sum:
    // n-tile jj holds keys 8jj + key_perm(0..7)
    float s[8][4], sl[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = sl[jj][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      uint32_t qh[4], ql[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qh[e] = qa[kk][e];
      } else {
        ldsm_x4(qh, qs + (lane & 15) * LDK + kk * 8 + (lane >> 4) * 4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ql[e] = tf32x3::lo_of_raw(qh[e]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + (np * 16 + (lane >> 4) * 8 + key_perm(lane & 7)) * LDK + kk * 8 +
                        ((lane >> 3) & 1) * 4);
        tf32x3::mma3_m16n8k8(s[2 * np], sl[2 * np], qh, ql, bb[0], bb[1]);
        tf32x3::mma3_m16n8k8(s[2 * np + 1], sl[2 * np + 1], qh, ql, bb[2], bb[3]);
      }
    }

    // online softmax in the registers; s becomes P (f32)
    float mx0 = NEG_INF, mx1 = NEG_INF;
    // this thread's first key
    const int key0 = VARLEN ? j * BKV + tg : TAIL ? live[j] * BKV + tg : 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if constexpr (VARLEN) {  // a key of another text: p = 0 exactly
        const int k = key0 + 8 * jj;
        s[jj][0] = k >= lo0 && k < hi0 ? (s[jj][0] + sl[jj][0]) * a.scale_log2 : -INFINITY;
        s[jj][1] = k + 4 >= lo0 && k + 4 < hi0 ? (s[jj][1] + sl[jj][1]) * a.scale_log2
                                               : -INFINITY;
        s[jj][2] = k >= lo1 && k < hi1 ? (s[jj][2] + sl[jj][2]) * a.scale_log2 : -INFINITY;
        s[jj][3] = k + 4 >= lo1 && k + 4 < hi1 ? (s[jj][3] + sl[jj][3]) * a.scale_log2
                                               : -INFINITY;
      } else {
        const float mk0 = ms[8 * jj + tg], mk1 = ms[8 * jj + tg + 4];
        s[jj][0] = mk0 > 0.0f ? (s[jj][0] + sl[jj][0]) * a.scale_log2 : NEG_INF;
        s[jj][1] = mk1 > 0.0f ? (s[jj][1] + sl[jj][1]) * a.scale_log2 : NEG_INF;
        s[jj][2] = mk0 > 0.0f ? (s[jj][2] + sl[jj][2]) * a.scale_log2 : NEG_INF;
        s[jj][3] = mk1 > 0.0f ? (s[jj][3] + sl[jj][3]) * a.scale_log2 : NEG_INF;
        if (TAIL) {  // no key at all: p = 0 whatever the row's maximum
          if (key0 + 8 * jj >= a.Tlen) s[jj][0] = s[jj][2] = -INFINITY;
          if (key0 + 8 * jj + 4 >= a.Tlen) s[jj][1] = s[jj][3] = -INFINITY;
        }
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
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s[jj][0] = exp2f(s[jj][0] - mn0);
      s[jj][1] = exp2f(s[jj][1] - mn0);
      s[jj][2] = exp2f(s[jj][2] - mn1);
      s[jj][3] = exp2f(s[jj][3] - mn1);
      sum0 += s[jj][0] + s[jj][1];
      sum1 += s[jj][2] + s[jj][3];
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

    // O (16 x DH) += P (16 x 64) V (64 x DH) on 3xTF32, the small terms
    // folded into O: k-step jj takes keys 8jj .. 8jj + 7 in order, so its
    // A fragment is S's n-tile jj as it stands
    next(2 * blk + 1);
    const float* vs = t_s + ((2 * blk + 1) % NST) * BKV * LDV;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t ph[4] = {__float_as_uint(s[jj][0]), __float_as_uint(s[jj][2]),
                              __float_as_uint(s[jj][1]), __float_as_uint(s[jj][3])};
      uint32_t pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pl[e] = tf32x3::lo_of_raw(ph[e]);
      const float* v0 = vs + (8 * jj + tg) * LDV + g;  // B: (key t, column g), (key t + 4, g)
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        tf32x3::mma3_m16n8k8(o[d], o[d], ph, pl, __float_as_uint(v0[8 * d]),
                             __float_as_uint(v0[4 * LDV + 8 * d]));
    }

    if (j + 1 == nl) {  // the head's last block: out = acc / l
      const float t0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1);
      const float t1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
      const float inv0 = 1.0f / fmaxf(t0 + __shfl_xor_sync(0xffffffffu, t0, 2), 1e-30f);
      const float inv1 = 1.0f / fmaxf(t1 + __shfl_xor_sync(0xffffffffu, t1, 2), 1e-30f);
      // the warp's own rows of this head's Q tile stage its output (the
      // tile is refilled two heads on, after a barrier)
      float* os = q_s + (hi % NQ) * BQ * LDK + warp * 16 * LDK;
      __syncwarp();
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        *reinterpret_cast<float2*>(os + g * LDK + 8 * d + 2 * tg) =
            make_float2(o[d][0] * inv0, o[d][1] * inv0);
        *reinterpret_cast<float2*>(os + (g + 8) * LDK + 8 * d + 2 * tg) =
            make_float2(o[d][2] * inv1, o[d][3] * inv1);
      }
      __syncwarp();
      float* dst = op + hi * a.o_sh;
      for (int e = lane; e < 16 * C4; e += 32) {
        const int r = e / C4, c = (e % C4) * 4;
        if (TAIL && warp * 16 + r >= q_rows) continue;
        *reinterpret_cast<float4*>(dst + r * a.o_st + c) =
            *reinterpret_cast<const float4*>(os + r * LDK + c);
      }
    }
    if (++j == nl) {
      j = 0;
      ++hi;
    }
  }
}

// Packed (VARLEN): B = 1, Tlen = 0, and a.nqb the caller's tiles.
template <int DH, bool TAIL, bool VARLEN = false>
int launch_tf32(Args a, int B, cudaStream_t st) {
  if (!VARLEN) a.nqb = (a.Tlen + TF_BQ - 1) / TF_BQ;
  a.hg = tf_q_tiles(DH) > 1 ? heads_per_cta(a.H, (long long)B * a.nqb) : 1;
  const size_t smem = tf_smem_bytes(DH, (a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * (a.H / a.hg) * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<DH, TAIL, VARLEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_tf32_kernel<DH, TAIL, VARLEN><<<(unsigned)grid, TF_NW * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch_tf32(const Args& a, int B, cudaStream_t st) {
  return a.Tlen % BKV ? launch_tf32<DH, true>(a, B, st) : launch_tf32<DH, false>(a, B, st);
}

// ------------------------------------------------------------- wide heads

// Head widths past 256 (any multiple of 8), every input type, on the
// tensor cores: bf16 and fp16 on the m16n8k16 products of the kernel above
// (P rounded to the input type), f32 on 3xTF32 as in the f32 path. One CTA
// of eight warps per (b, h, 64 query rows), S = Q K^T computed once per key
// block over the whole of Dh. Nothing of that width fits registers or a
// ring stage whole, so Q, K and V stream through a cp.async ring in chunks
// of 64 columns (64 rows of Q and of K a stage for S, 64 keys of V for
// P V), and the warps split the work two ways: warp w takes the 16 rows
// 16 (w % 4) and, of S, the 32 keys 32 (w / 4); of O, the 32 columns
// 32 (w / 4) of every 64-column chunk, so O costs Dh / 4 registers a thread.
// S goes to shared memory for the online softmax (four threads a row), and
// P comes back as each warp's A fragments of its 16 rows, in the input type
// (f32: raw, its lo part taken as it is used). Up to NCH chunks of O a CTA
// (5: Dh <= 320, 9: <= 576); past 576 the columns go to groups of 576, one
// CTA each, which compute the same S. Two CTAs an SM for bf16 and fp16 up to
// Dh 320 (128 registers), whose barriers a chunk otherwise leave the SM
// idle; one otherwise. Dead key blocks, masks, tails and all-masked rows
// follow the rules above.
constexpr int WCH = 64;          // columns of a Q, K or V chunk
constexpr int W_THREADS = 256;   // eight warps
constexpr int W_NST = 3;         // ring stages
constexpr int W_LDC = WCH + 8;   // chunk row stride (elements); f32 Q, K and P: WCH + 4
constexpr int W_SLD = BKV + 4;   // row stride of the S tile (f32)

template <typename T>
__host__ __device__ inline size_t wide_smem_bytes(int nkb) {
  const int ldp = sizeof(T) == 4 ? WCH + 4 : W_LDC;
  return ((size_t)W_NST * 2 * BKV * W_LDC + (size_t)BKV * ldp) * sizeof(T) +
         ((size_t)BKV * W_SLD + 2 * BKV) * 4 + (size_t)nkb * 8;
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = Mma<T>::pack(x, y);
}

template <typename T, int NCH>
__global__ void __launch_bounds__(W_THREADS, sizeof(T) == 2 && NCH <= 5 ? 2 : 1)
    flash_wide_kernel(const Args a, int dh, int ncg) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDQK = F32 ? WCH + 4 : W_LDC, LDP = LDQK, VEC = 16 / sizeof(T), CV = WCH / VEC;
  constexpr int KS = F32 ? 8 : 16;  // keys (and columns) a product step
  extern __shared__ __align__(128) unsigned char smem[];
  T* c_s = reinterpret_cast<T*>(smem);  // [W_NST][2][BKV][W_LDC]: Q and K chunks, or a V chunk
  T* p_s = c_s + W_NST * 2 * BKV * W_LDC;                     // [BKV][LDP]: P
  float* s_s = reinterpret_cast<float*>(p_s + BKV * LDP);     // [BKV][W_SLD]: S
  float* al_s = s_s + BKV * W_SLD;                            // [BKV] each row's alpha
  float* l_s = al_s + BKV;                                    // [BKV] each row's sum, at the end
  int* live = reinterpret_cast<int*>(l_s + BKV);              // [nkb], then flags [nkb]
  __shared__ int n_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = warp & 3, wh = warp >> 2;  // rows 16 wr; keys (S) or columns (O) 32 wh
  const int Tlen = a.Tlen;
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
  const int row0 = qb * BKV, col0 = cg * NCH * WCH;
  const int nchs = (dh + WCH - 1) / WCH;                         // chunks of S's sum
  const int nchv = min(NCH, (dh - col0 + WCH - 1) / WCH);        // chunks of V and O here
  const int ipb = nchs + nchv;                                   // ring items a key block

  const int nl = find_live_blocks(mp, Tlen, live, &n_live);
  const int n_items = nl * ipb;

  // rows r0 .. r0 + 63 of x (zero at or past T), columns c0 .. c0 + 63
  // (zero at or past dh), to dst with rows ld apart
  auto load_tile = [&](T* dst, int ld, const T* x, long long st, long long r0, int c0) {
    for (int i = tid; i < BKV * CV; i += W_THREADS) {
      const int r = i / CV, c = (i % CV) * VEC;
      const bool ok = r0 + r < Tlen && c0 + c < dh;
      cp_async16_zfill(dst + r * ld + c, x + (ok ? (r0 + r) * st + c0 + c : 0), ok);
    }
  };
  // item it of key block it / ipb: S's chunk c (Q and K) for c < nchs, else
  // V's chunk c - nchs of this CTA's columns
  auto load_item = [&](int it) {
    const int kb = live[it / ipb], c = it % ipb;
    T* dst = c_s + (it % W_NST) * 2 * BKV * W_LDC;
    if (c < nchs) {
      load_tile(dst, LDQK, qp, a.q_st, row0, c * WCH);
      load_tile(dst + BKV * W_LDC, LDQK, kp, a.k_st, (long long)kb * BKV, c * WCH);
    } else {
      load_tile(dst, W_LDC, vp, a.v_st, (long long)kb * BKV, col0 + (c - nchs) * WCH);
    }
  };
  for (int it = 0; it < W_NST - 1; ++it) {
    if (it < n_items) load_item(it);
    cp_async_commit();
  }
  auto next = [&](int i) {  // as in the f32 path
    cp_async_wait<W_NST - 2>();
    __syncthreads();
    if (i + W_NST - 1 < n_items) load_item(i + W_NST - 1);
    cp_async_commit();
    return c_s + (i % W_NST) * 2 * BKV * W_LDC;
  };

  float o[NCH][4][4];  // chunk c: columns col0 + 64c + 32wh + 8n + 2tg + {0, 1}
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int n = 0; n < 4; ++n) o[c][n][0] = o[c][n][1] = o[c][n][2] = o[c][n][3] = 0.0f;
  const int srow = tid >> 2, part = tid & 3;  // the softmax's row and quarter
  float m_run = NEG_INF, l_run = 0.0f;

  for (int j = 0, i = 0; j < nl; ++j) {
    const int kb = live[j];
    // this warp's S (16 x 32) over Dh, chunk by chunk; f32: small terms apart
    float s[4][4], sl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.0f;
    for (int c = 0; c < nchs; ++c) {
      const T* stage = next(i++);
      const T* qs = stage + wr * 16 * LDQK;
      const T* ks = stage + BKV * W_LDC + wh * 32 * LDQK;
#pragma unroll
      for (int kk = 0; kk < WCH / KS; ++kk) {
        uint32_t qa[4], ql[4];
        ldsm_x4(qa, qs + (lane & 15) * LDQK + kk * KS + (lane >> 4) * (KS / 2));
        if constexpr (F32) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ql[e] = tf32x3::lo_of_raw(qa[e]);
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDQK + kk * KS +
                          ((lane >> 3) & 1) * (KS / 2));
          if constexpr (F32) {
            tf32x3::mma3_m16n8k8(s[2 * np], sl[2 * np], qa, ql, bb[0], bb[1]);
            tf32x3::mma3_m16n8k8(s[2 * np + 1], sl[2 * np + 1], qa, ql, bb[2], bb[3]);
          } else {
            Mma<T>::run(s[2 * np], qa, bb[0], bb[1]);
            Mma<T>::run(s[2 * np + 1], qa, bb[2], bb[3]);
          }
        }
      }
    }
    // to the S tile, scaled (log2 units) and masked
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = wh * 32 + 8 * n + 2 * tg + e, k = kb * BKV + key;
        const bool past = k >= Tlen, real = !past && mp[k] > 0.0f;
        const float v0 = F32 ? s[n][e] + sl[n][e] : s[n][e];
        const float v1 = F32 ? s[n][2 + e] + sl[n][2 + e] : s[n][2 + e];
        s_s[(wr * 16 + g) * W_SLD + key] = past ? -INFINITY : (real ? v0 * a.scale_log2 : NEG_INF);
        s_s[(wr * 16 + g + 8) * W_SLD + key] =
            past ? -INFINITY : (real ? v1 * a.scale_log2 : NEG_INF);
      }
    __syncthreads();
    {  // online softmax: four threads a row, sixteen keys each; P in T
      const float* sr = s_s + srow * W_SLD + part * 16;
      T* pr = p_s + srow * LDP + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, sr[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run, mx);
      const float al = exp2f(m_run - mn);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const float p0 = exp2f(sr[e] - mn), p1 = exp2f(sr[e + 1] - mn);
        sum += p0 + p1;
        store_pair(pr + e, p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * al + sum;
      m_run = mn;
      if (part == 0) al_s[srow] = al;
    }
    __syncthreads();
    // P's A fragments of this warp's 16 rows, every key of the block
    uint32_t pa[BKV / KS][4];
#pragma unroll
    for (int kk = 0; kk < BKV / KS; ++kk)
      ldsm_x4(pa[kk], p_s + (wr * 16 + (lane & 15)) * LDP + kk * KS + (lane >> 4) * (KS / 2));
    const float al0 = al_s[wr * 16 + g], al1 = al_s[wr * 16 + g + 8];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[c][n][0] *= al0;
        o[c][n][1] *= al0;
        o[c][n][2] *= al1;
        o[c][n][3] *= al1;
      }
    // O += P V, chunk by chunk: this warp's 32 columns of each
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c >= nchv) break;
      const T* vs = next(i++) + wh * 32;
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk) {
          uint32_t pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) pl[e] = tf32x3::lo_of_raw(pa[kk][e]);
          const float* v0 = vs + (8 * kk + tg) * W_LDC + g;  // (key t, column g), (t + 4, g)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            tf32x3::mma3_m16n8k8(o[c][n], o[c][n], pa[kk], pl, __float_as_uint(v0[8 * n]),
                                 __float_as_uint(v0[4 * W_LDC + 8 * n]));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int dp = 0; dp < 2; ++dp) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * W_LDC +
                                  dp * 16 + (lane >> 4) * 8);
            Mma<T>::run(o[c][2 * dp], pa[kk], bb[0], bb[1]);
            Mma<T>::run(o[c][2 * dp + 1], pa[kk], bb[2], bb[3]);
          }
      }
    }
  }

  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
  const float inv0 = 1.0f / fmaxf(l_s[wr * 16 + g], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l_s[wr * 16 + g + 8], 1e-30f);
  const int r0 = row0 + wr * 16 + g;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (c >= nchv) break;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = col0 + c * WCH + wh * 32 + 8 * n + 2 * tg;
      if (col >= dh) continue;  // dh is a multiple of 8: the pair is whole
      if (r0 < Tlen) store_pair(op + (long long)r0 * a.o_st + col, o[c][n][0] * inv0,
                                o[c][n][1] * inv0);
      if (r0 + 8 < Tlen)
        store_pair(op + (long long)(r0 + 8) * a.o_st + col, o[c][n][2] * inv1,
                   o[c][n][3] * inv1);
    }
  }
}

template <typename T, int NCH>
int launch_wide_n(Args a, int B, int dh, cudaStream_t st) {
  a.nqb = (a.Tlen + BKV - 1) / BKV;
  a.hg = 1;
  const int ncg = (dh + NCH * WCH - 1) / (NCH * WCH);
  const size_t smem = wide_smem_bytes<T>((a.Tlen + BKV - 1) / BKV);
  const long long grid = (long long)a.nqb * ncg * a.H * B;
  if (grid > INT_MAX || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_kernel<T, NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_wide_kernel<T, NCH><<<(unsigned)grid, W_THREADS, smem, st>>>(a, dh, ncg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const Args& a, int B, int dh, cudaStream_t st) {
  return dh <= 5 * WCH ? launch_wide_n<T, 5>(a, B, dh, st) : launch_wide_n<T, 9>(a, B, dh, st);
}

int dispatch_f32(const Args& a, int B, int Dh, cudaStream_t st) {
  if (Dh > 256) return launch_wide<float>(a, B, Dh, st);
  switch (Dh) {
    case 16: return dispatch_tf32<16>(a, B, st);
    case 32: return dispatch_tf32<32>(a, B, st);
    case 64: return dispatch_tf32<64>(a, B, st);
    case 128: return dispatch_tf32<128>(a, B, st);
    case 256: return dispatch_tf32<256>(a, B, st);
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

// the packed entry's kernels by head width: 64-row tiles in every dtype
template <typename T>
int dispatch_varlen(const Args& a, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<16, T, 4, true, true>(a, 1, st);
    case 32: return launch<32, T, 4, true, true>(a, 1, st);
    case 64: return launch<64, T, 4, true, true>(a, 1, st);
    case 128: return launch<128, T, 4, true, true>(a, 1, st);
    case 256: return launch<256, T, 4, true, true>(a, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the causal grouped-K/V form (LM) at the head widths a language model's
// attention takes
template <typename T>
int dispatch_varlen_lm(const Args& a, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch<32, T, 4, true, true, true>(a, 1, st);
    case 64: return launch<64, T, 4, true, true, true>(a, 1, st);
    case 128: return launch<128, T, 4, true, true, true>(a, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_varlen_f32(const Args& a, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_tf32<16, true, true>(a, 1, st);
    case 32: return launch_tf32<32, true, true>(a, 1, st);
    case 64: return launch_tf32<64, true, true>(a, 1, st);
    case 128: return launch_tf32<128, true, true>(a, 1, st);
    case 256: return launch_tf32<256, true, true>(a, 1, st);
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
  a.cu = a.tiles = nullptr;
  a.kv_group = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<__nv_bfloat16>(a, B, Dh, st);
  if (dtype == 1) return dispatch_dh<__half>(a, B, Dh, st);
  if (dtype == 2) return dispatch_f32(a, B, Dh, st);
  return (int)cudaErrorInvalidValue;
}

// Packed texts: q, k, v and o (N, H, Dh), their (h, t) element strides in
// that order (8), the head dimension contiguous; cu (rows + 1) int32 token
// offsets of the texts; tiles (n_tiles, 4) int32, each a tile's first row,
// its end (at most 64 rows on), the text of its first row and one past the
// text of its last row. Dh one of 16, 32, 64, 128, 256; dtype as above.
// Pointers and strides 16-byte aligned as above. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_varlen_fwd(const void* q, const void* k, const void* v, void* o,
                                          const int* cu, const int* tiles, int n_tiles, int H,
                                          int Dh, const long long* strides, float scale,
                                          int dtype, void* stream) {
  if (n_tiles <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (align % 16) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 2 ? 4 : 8;  // elements in 16 bytes
  for (int i = 0; i < 8; ++i)
    if (strides[i] % vec) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = nullptr;
  a.o = o;
  a.q_sb = a.k_sb = a.v_sb = a.o_sb = 0;
  a.q_sh = strides[0], a.q_st = strides[1];
  a.k_sh = strides[2], a.k_st = strides[3];
  a.v_sh = strides[4], a.v_st = strides[5];
  a.o_sh = strides[6], a.o_st = strides[7];
  a.H = H;
  a.Tlen = 0;
  a.nqb = n_tiles;
  a.hg = 0;
  a.scale_log2 = scale * LOG2E;
  a.cu = cu;
  a.tiles = tiles;
  a.kv_group = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_varlen<__nv_bfloat16>(a, Dh, st);
  if (dtype == 1) return dispatch_varlen<__half>(a, Dh, st);
  if (dtype == 2) return dispatch_varlen_f32(a, Dh, st);
  return (int)cudaErrorInvalidValue;
}

// Packed texts of a causal language model (the LM instantiation): as
// flash_attention_varlen_fwd, and a row attends to its own text's keys up
// to itself; k and v hold H / kv_group heads, query head h reading K/V head
// h / kv_group. Dh one of 32, 64, 128; dtype 0 (bfloat16) or 1 (float16).
extern "C" int flash_attention_varlen_lm_fwd(const void* q, const void* k, const void* v,
                                             void* o, const int* cu, const int* tiles,
                                             int n_tiles, int H, int kv_group, int Dh,
                                             const long long* strides, float scale, int dtype,
                                             void* stream) {
  if (n_tiles <= 0 || H <= 0 || kv_group <= 0 || H % kv_group) return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (align % 16) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = nullptr;
  a.o = o;
  a.q_sb = a.k_sb = a.v_sb = a.o_sb = 0;
  a.q_sh = strides[0], a.q_st = strides[1];
  a.k_sh = strides[2], a.k_st = strides[3];
  a.v_sh = strides[4], a.v_st = strides[5];
  a.o_sh = strides[6], a.o_st = strides[7];
  a.H = H;
  a.Tlen = 0;
  a.nqb = n_tiles;
  a.hg = 0;
  a.scale_log2 = scale * LOG2E;
  a.cu = cu;
  a.tiles = tiles;
  a.kv_group = kv_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_varlen_lm<__nv_bfloat16>(a, Dh, st);
  if (dtype == 1) return dispatch_varlen_lm<__half>(a, Dh, st);
  return (int)cudaErrorInvalidValue;
}
