// Batched Gram matrix S[b] = E[b] E[b]^T in full f32, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/similarity.py::_sim_kernel (the Pallas TPU
// kernel launched by similarity_matrix_pallas), and serves every E E^T of
// the chunking path: similarity_matrix, batched_split_signals and
// batched_similarity_matrices.
//
// What it computes. E (B, n, d) f32 or bf16 contiguous, S (B, n, n) f32 with
// S[b][i][j] = sum_k E[b][i][k] * E[b][j][k]. Every output element is one
// chain acc = fmaf(E[i][k], E[j][k], acc) over k = 0, 1, ..., d-1 starting
// from 0, on the CUDA cores: no TF32, no bf16, no tensor-core MMA, because
// boundary decisions hang on small similarity differences (the JAX callers
// ask for Precision.HIGHEST). The chain's order does not depend on the tile
// shape, on an element's place in its tile or on the batch, and there is no
// split-K and no atomic. So two launches agree bit for bit, a document gives
// the same bits alone or inside a padded batch, and S[b] equals its own
// transpose bit for bit (fmaf(a, b, c) == fmaf(b, a, c)). A bf16 E is widened
// to f32 as it is loaded (the JAX kernel takes the input's dtype and
// accumulates in f32): a product of two bf16 values is exact in f32, so the
// same chains run on the widened values.
//
// What bounds it on this card. S is symmetric, so the function needs
// B*n*(n+1)/2 dot products of width d, B*n*(n+1)*d operations, against
// 4*B*(n*d + n^2) bytes. At d = 384 that is above the f32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte) from about n = 100: the long
// buckets are bound by operations (88 per byte at n = 4096), a batch of
// 64-sentence documents by bytes (14 per byte). This kernel computes the
// full square, twice the products needed.
//
// What the design does about it. A classic tiled SIMT product. Grid
// (tiles, tiles, B); a CTA of 256 threads owns one square output tile, 128
// wide with an 8 x 8 register micro-tile per thread when that still fills
// the card, else 64 wide with 4 x 4. The K loop steps 16 columns at a time
// through a double-buffered shared-memory pair of operand tiles, stored
// k-major so a thread reads its micro-tile operands as float4; the next
// step's global loads are issued before the current step's FMAs. Diagonal
// tiles (every tile of a short document) load one operand instead of two.
// No padded copy of E and no slice afterwards: loads past n or d read as
// zero and stores past n are skipped.
// Not yet done (later work): a 3xTF32 split on wgmma, computing only the
// upper triangle and mirroring it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;        // K columns per step
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_GRID_Z = 65535;

// One operand tile's share of a thread: LOADS float4 of E, kept in registers
// between the global load and the shared-memory store.
template <int LOADS>
struct Frag {
  float4 v[LOADS];
};

// four consecutive elements as f32: one 16-byte load of f32, one 8-byte
// load of bf16 widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Rows row0.. of E[b], columns k0..k0+15, as float4 (row, 4 columns); zero
// past n and past d. VEC: d is a multiple of 4, so four elements are whole
// and aligned to their size.
template <int LOADS, bool VEC, typename E>
__device__ __forceinline__ void load_tile(Frag<LOADS>& f, const E* __restrict__ e, int n, int d,
                                          int row0, int k0, int tid) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = tid + l * THREADS;
    const int row = row0 + (idx >> 2);
    const int k = k0 + (idx & 3) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      const E* p = e + (size_t)row * d + k;
      if (VEC) {
        if (k < d) v = load4(p);
      } else {
        if (k + 0 < d) v.x = to_f32(p[0]);
        if (k + 1 < d) v.y = to_f32(p[1]);
        if (k + 2 < d) v.z = to_f32(p[2]);
        if (k + 3 < d) v.w = to_f32(p[3]);
      }
    }
    f.v[l] = v;
  }
}

// Transposed store: tile[k][m], row stride LD.
template <int LOADS, int LD>
__device__ __forceinline__ void store_tile(const Frag<LOADS>& f, float* tile, int tid) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int idx = tid + l * THREADS;
    const int m = idx >> 2;
    const int k = (idx & 3) * 4;
    tile[(k + 0) * LD + m] = f.v[l].x;
    tile[(k + 1) * LD + m] = f.v[l].y;
    tile[(k + 2) * LD + m] = f.v[l].z;
    tile[(k + 3) * LD + m] = f.v[l].w;
  }
}

// H = 1: 64 x 64 tile, 4 x 4 per thread. H = 2: 128 x 128 tile, 8 x 8 per
// thread as four 4 x 4 quadrants 64 apart, so that the 16 threads of a
// half-warp read 64 consecutive floats of an operand row.
template <int H, bool VEC, typename E>
__global__ void __launch_bounds__(THREADS, 2)  // two CTAs per SM: <= 128 registers
gram_kernel(const E* __restrict__ emb, float* __restrict__ out, int n, int d, int batch0) {
  constexpr int BM = 64 * H;
  constexpr int LD = BM + 4;
  constexpr int LOADS = BM * BK / 4 / THREADS;
  constexpr int TM = 4 * H;
  __shared__ __align__(16) float tiles[2][2][BK * LD];  // [buffer][operand][k][m]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = batch0 + blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BM;
  const bool diag = blockIdx.x == blockIdx.y;
  const E* e = emb + (size_t)b * n * d;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  Frag<LOADS> fa, fb;
  load_tile<LOADS, VEC, E>(fa, e, n, d, i0, 0, tid);
  if (!diag) load_tile<LOADS, VEC, E>(fb, e, n, d, j0, 0, tid);
  store_tile<LOADS, LD>(fa, tiles[0][0], tid);
  if (!diag) store_tile<LOADS, LD>(fb, tiles[0][1], tid);
  __syncthreads();

  const int steps = (d + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {
      load_tile<LOADS, VEC, E>(fa, e, n, d, i0, (s + 1) * BK, tid);
      if (!diag) load_tile<LOADS, VEC, E>(fb, e, n, d, j0, (s + 1) * BK, tid);
    }
    const float* as = tiles[cur][0];
    const float* bs = diag ? as : tiles[cur][1];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TM];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 va = *reinterpret_cast<const float4*>(as + kk * LD + h * 64 + ty * 4);
        const float4 vb = *reinterpret_cast<const float4*>(bs + kk * LD + h * 64 + tx * 4);
        a[h * 4 + 0] = va.x; a[h * 4 + 1] = va.y; a[h * 4 + 2] = va.z; a[h * 4 + 3] = va.w;
        bv[h * 4 + 0] = vb.x; bv[h * 4 + 1] = vb.y; bv[h * 4 + 2] = vb.z; bv[h * 4 + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) {
      // the other buffer was last read in step s-1, before that step's sync
      store_tile<LOADS, LD>(fa, tiles[cur ^ 1][0], tid);
      if (!diag) store_tile<LOADS, LD>(fb, tiles[cur ^ 1][1], tid);
    }
    __syncthreads();
  }

  float* o = out + (size_t)b * n * n;
  const bool vec_out = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (row >= n) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int col = j0 + h * 64 + tx * 4;
      float* p = o + (size_t)row * n + col;
      if (vec_out) {
        if (col < n)
          *reinterpret_cast<float4*>(p) = make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1],
                                                      acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) p[c] = acc[i][h * 4 + c];
      }
    }
  }
}

template <int H, bool VEC, typename E>
int launch(const E* emb, float* out, int B, int n, int d, cudaStream_t st, int* launched) {
  constexpr int BM = 64 * H;
  const int tiles = (n + BM - 1) / BM;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int nb = B - b0 < MAX_GRID_Z ? B - b0 : MAX_GRID_Z;
    gram_kernel<H, VEC, E><<<dim3(tiles, tiles, nb), THREADS, 0, st>>>(emb, out, n, d, b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaSuccess;
}

template <typename E>
int gram(const E* e, float* o, int B, int n, int d, cudaStream_t st, int* launched) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // the wide tile only when its CTAs still cover every SM; the bits of S do
  // not depend on the choice
  const long long wide_tiles = (long long)((n + 127) / 128) * ((n + 127) / 128) * B;
  const bool wide = n >= 128 && wide_tiles >= sms;
  const bool vec = (d & 3) == 0;
  if (wide)
    return vec ? launch<2, true, E>(e, o, B, n, d, st, launched)
               : launch<2, false, E>(e, o, B, n, d, st, launched);
  return vec ? launch<1, true, E>(e, o, B, n, d, st, launched)
             : launch<1, false, E>(e, o, B, n, d, st, launched);
}

}  // namespace

// emb (B, n, d) contiguous, f32 (dtype 0) or bf16 (dtype 1); out (B, n, n)
// f32. Any n, d >= 1. Returns cudaGetLastError() after the launches (one per
// 65,535 documents) and adds the number of kernels launched to *launched.
extern "C" int similarity_gram(const void* emb, void* out, int B, int n, int d, int dtype,
                               void* stream, int* launched) {
  if (B <= 0 || n <= 0 || d <= 0 || (n + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return gram(static_cast<const float*>(emb), o, B, n, d, st, launched);
  if (dtype == 1) return gram(static_cast<const __nv_bfloat16*>(emb), o, B, n, d, st, launched);
  return (int)cudaErrorInvalidValue;
}
