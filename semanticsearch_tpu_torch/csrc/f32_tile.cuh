// The score tile of the two top-k kernels' f32 schedules (segtopk.cu mode 3,
// topk_fused.cu's f32 kernel), for Hopper (sm_90a): the 64 x 128 scores of
// query rows q0.. against corpus rows r0.., in full f32 on the CUDA cores.
//
// Every score is one chain acc = fmaf(q[k], c[k], acc) over k = 0, 1, ...,
// D-1 from 0, as in similarity.cu: no TF32, no split of K, no atomic. A
// tensor-core TF32 product keeps a 10-bit mantissa, about 5e-4 of error per
// product, twenty times what an f32 index may differ from the exact f32 top-k;
// on integer-valued rows every chain here is exact and equals the plain f32
// product bit for bit, whatever order that one sums in.
//
// What bounds it: 2 * 64 * 128 * D operations a tile at 67 TFLOP/s (f32
// outside the tensor cores), against (64 + 128) * D * 4 bytes, 21 operations
// per byte from L2. The design is the classic tiled SIMT product: 256
// threads, a 4 x 8 register micro-tile each (rows ty*4.., columns
// h*64 + tx*4..), K in steps of 16 columns through a double-buffered pair of
// k-major shared-memory tiles, so a thread reads its operands as float4; the
// next step's global loads go out before the current step's FMAs. Loads past
// the valid rows or past D read as zero.
#pragma once

#include <cuda_runtime.h>

namespace f32t {

constexpr int BQ = 64;        // query rows of a tile
constexpr int BN = 128;       // corpus rows of a tile
constexpr int BK = 16;        // K columns a step
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDA = BQ + 4, LDB = BN + 4;
constexpr int SLD = BN + 4;   // row stride of the score tile the kernels read

// the operand tiles: [buffer][k][row], k-major
struct Operands {
  float a[2][BK * LDA];
  float b[2][BK * LDB];
};

template <int ROWS>
struct Frag {
  float4 v[ROWS * BK / 4 / THREADS];
};

// rows row0.. (valid below n_rows) of the row-major (., D) matrix x, columns
// k0..k0+15, as (row, 4 columns) float4s; zero past n_rows and past D
template <int ROWS>
__device__ __forceinline__ void load(Frag<ROWS>& f, const float* __restrict__ x, long long n_rows,
                                     int D, long long row0, int k0, bool vec) {
#pragma unroll
  for (int l = 0; l < ROWS * BK / 4 / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const long long row = row0 + (idx >> 2);
    const int k = k0 + (idx & 3) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const float* p = x + row * D + k;
      if (vec) {
        if (k < D) v = *reinterpret_cast<const float4*>(p);
      } else {
        if (k + 0 < D) v.x = p[0];
        if (k + 1 < D) v.y = p[1];
        if (k + 2 < D) v.z = p[2];
        if (k + 3 < D) v.w = p[3];
      }
    }
    f.v[l] = v;
  }
}

// transposed store: tile[k][row], row stride LD
template <int ROWS, int LD>
__device__ __forceinline__ void store(const Frag<ROWS>& f, float* tile) {
#pragma unroll
  for (int l = 0; l < ROWS * BK / 4 / THREADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const int m = idx >> 2;
    const int k = (idx & 3) * 4;
    tile[(k + 0) * LD + m] = f.v[l].x;
    tile[(k + 1) * LD + m] = f.v[l].y;
    tile[(k + 2) * LD + m] = f.v[l].z;
    tile[(k + 3) * LD + m] = f.v[l].w;
  }
}

// s[r * SLD + j] = q[q0 + r] . c[r0 + j] for r < 64, j < 128: query rows at
// or past Q and corpus rows at or past n_rows score 0. All 256 threads call
// it; it synchronises the block on the way in and out, so s may be read
// after it returns and the operand tiles reused by the next call.
__device__ __forceinline__ void score_tile(const float* __restrict__ q, const float* __restrict__ c,
                                           int Q, long long n_rows, int D, int q0, long long r0,
                                           Operands& op, float* __restrict__ s) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool vec = (D & 3) == 0;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Frag<BQ> fa;
  Frag<BN> fb;
  __syncthreads();  // the previous call's readers are done with the tiles
  load<BQ>(fa, q, Q, D, q0, 0, vec);
  load<BN>(fb, c, n_rows, D, r0, 0, vec);
  store<BQ, LDA>(fa, op.a[0]);
  store<BN, LDB>(fb, op.b[0]);
  __syncthreads();
  const int steps = (D + BK - 1) / BK;
  for (int st = 0; st < steps; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < steps;
    if (more) {
      load<BQ>(fa, q, Q, D, q0, (st + 1) * BK, vec);
      load<BN>(fb, c, n_rows, D, r0, (st + 1) * BK, vec);
    }
    const float* as = op.a[cur];
    const float* bs = op.b[cur];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 va = *reinterpret_cast<const float4*>(as + kk * LDA + ty * 4);
      const float4 vb0 = *reinterpret_cast<const float4*>(bs + kk * LDB + tx * 4);
      const float4 vb1 = *reinterpret_cast<const float4*>(bs + kk * LDB + 64 + tx * 4);
      const float a[4] = {va.x, va.y, va.z, va.w};
      const float b[8] = {vb0.x, vb0.y, vb0.z, vb0.w, vb1.x, vb1.y, vb1.z, vb1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read in step st-1, before that step's sync
      store<BQ, LDA>(fa, op.a[cur ^ 1]);
      store<BN, LDB>(fb, op.b[cur ^ 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = s + (ty * 4 + i) * SLD;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(row + h * 64 + tx * 4) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
  }
  __syncthreads();
}

}  // namespace f32t
