// Non-causal attention forward with a key-padding mask, for Hopper (sm_90a).
//
// Replaces: semanticsearch_tpu/ops/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel launched by _flash_fwd_impl).
//
// What it computes. q, k, v (B, H, T, Dh) in bf16 or fp16, mask (B, T) f32
// with 1 = real key. Scores s = (q.k) / sqrt(Dh) in f32; a masked key scores
// the finite -1e30 (not -inf), so a query whose keys are all masked gets the
// mean of V, as the TPU kernel and the plain reference do. Online softmax
// over KV blocks with the (m, l, acc) recurrence in f32; out = acc / max(l,
// 1e-30), written in q's dtype.
//
// What bounds it on this card. 4*B*H*T^2*Dh operations against 8*B*H*T*Dh
// bytes of q, k, v and o: T/2 operations per byte. At the encoder's T = 64
// to 256 that is below the ~295 FLOP/byte ridge, so it is bound by memory
// at T <= ~512 and by the tensor cores above (T = 1024 under "auto").
//
// What the design does about it. Grid (T/64, H, B): each CTA of 4 warps
// keeps its 64-row Q tile in shared memory and streams K and V once through
// shared memory in 64-row blocks; every byte of q, k, v is read once per
// query block and the (T, T) score matrix never reaches device memory. Both
// products (Q K^T and P V) run on tensor cores (WMMA 16x16x16, f32
// accumulation); each warp owns 16 query rows, so the softmax statistics of a
// row live in the two lanes that update it and no block-wide sync is needed
// between the products. P is rounded to the input dtype for the P V
// product, as FlashAttention does; the running sum l stays in f32.
// Not yet done (later work): wgmma, TMA, double-buffered K/V, keeping O in
// registers instead of shared memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SLD = BKV + 4;  // f32 row stride of a warp's score tile
constexpr int PLD = BKV + 8;  // row stride of a warp's P tile
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <int DH, typename T>
struct Layout {
  static constexpr int LD = DH + 8;  // row stride of the Q, K, V tiles
  static constexpr int OLD = DH + 4; // f32 row stride of a warp's O tile
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(T) * BQ * LD);
  static constexpr size_t v = align128(k + sizeof(T) * BKV * LD);
  static constexpr size_t s = align128(v + sizeof(T) * BKV * LD);
  static constexpr size_t p = align128(s + sizeof(float) * WARPS * 16 * SLD);
  static constexpr size_t o = align128(p + sizeof(T) * WARPS * 16 * PLD);
  static constexpr size_t m = align128(o + sizeof(float) * WARPS * 16 * OLD);
  static constexpr size_t total = align128(m + sizeof(float) * BKV);
};

template <typename T> __device__ inline T from_float(float x);
template <> __device__ inline __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
template <> __device__ inline __half from_float(float x) { return __float2half(x); }

template <int DH, typename T>
__device__ inline void load_tile(T* dst, const T* src, int tid) {
  constexpr int VEC = DH / 8;  // 16-byte vectors per row
  for (int idx = tid; idx < 64 * VEC; idx += THREADS) {
    int r = idx / VEC, c = (idx % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * Layout<DH, T>::LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * DH + c);
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mask, T* __restrict__ o, int H, int Tlen,
                 float scale) {
  using Lay = Layout<DH, T>;
  constexpr int LD = Lay::LD, OLD = Lay::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem + Lay::q);
  T* k_s = reinterpret_cast<T*>(smem + Lay::k);
  T* v_s = reinterpret_cast<T*>(smem + Lay::v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* s_w = reinterpret_cast<float*>(smem + Lay::s) + warp * 16 * SLD;
  T* p_w = reinterpret_cast<T*>(smem + Lay::p) + warp * 16 * PLD;
  float* o_w = reinterpret_cast<float*>(smem + Lay::o) + warp * 16 * OLD;
  float* m_s = reinterpret_cast<float*>(smem + Lay::m);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * Tlen * DH;
  load_tile<DH, T>(q_s, q + head + (size_t)qb * BQ * DH, tid);
  for (int idx = lane; idx < 16 * OLD; idx += 32) o_w[idx] = 0.0f;

  // two lanes per query row: lane pair (2r, 2r+1) owns row r of this warp
  const int row = lane / 2, half = lane % 2;
  float m_run = NEG_INF, l_run = 0.0f;

  for (int kb = 0; kb < Tlen / BKV; ++kb) {
    __syncthreads();  // previous K, V tiles fully consumed
    load_tile<DH, T>(k_s, k + head + (size_t)kb * BKV * DH, tid);
    load_tile<DH, T>(v_s, v + head + (size_t)kb * BKV * DH, tid);
    for (int idx = tid; idx < BKV; idx += THREADS)
      m_s[idx] = mask[(size_t)b * Tlen + kb * BKV + idx];
    __syncthreads();

    // S (16 x 64) = Q_w (16 x DH) . K^T
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
        wmma::load_matrix_sync(a, q_s + (warp * 16) * LD + kk * 16, LD);
        wmma::load_matrix_sync(bf, k_s + (j * 16) * LD + kk * 16, LD);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(s_w + j * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax for row `row`, keys [half*32, half*32+32)
    float* srow = s_w + row * SLD + half * 32;
    float mx = NEG_INF;
    for (int j = 0; j < 32; ++j) {
      float sv = m_s[half * 32 + j] > 0.0f ? srow[j] * scale : NEG_INF;
      srow[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.0f;
    T* prow = p_w + row * PLD + half * 32;
    for (int j = 0; j < 32; ++j) {
      float p = expf(srow[j] - m_new);
      sum += p;
      prow[j] = from_float<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    float* orow = o_w + row * OLD + half * (DH / 2);
    for (int d = 0; d < DH / 2; ++d) orow[d] *= alpha;
    __syncwarp();

    // O_w (16 x DH) += P_w (16 x 64) . V (64 x DH)
    for (int dj = 0; dj < DH / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + dj * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
        wmma::load_matrix_sync(a, p_w + kk * 16, PLD);
        wmma::load_matrix_sync(bf, v_s + (kk * 16) * LD + dj * 16, LD);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(o_w + dj * 16, acc, OLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const float inv = 1.0f / fmaxf(l_run, 1e-30f);
  T* out = o + head + ((size_t)qb * BQ + warp * 16 + row) * DH + half * (DH / 2);
  const float* orow = o_w + row * OLD + half * (DH / 2);
  for (int d = 0; d < DH / 2; ++d) out[d] = from_float<T>(orow[d] * inv);
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const float* mask, void* o, int B, int H,
           int Tlen, float scale, cudaStream_t st) {
  constexpr size_t smem = Layout<DH, T>::total;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tlen / BQ, H, B);
  flash_fwd_kernel<DH, T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(o), H, Tlen, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, const float* mask, void* o, int B,
                int H, int Tlen, int Dh, float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<16, T>(q, k, v, mask, o, B, H, Tlen, scale, st);
    case 32: return launch<32, T>(q, k, v, mask, o, B, H, Tlen, scale, st);
    case 64: return launch<64, T>(q, k, v, mask, o, B, H, Tlen, scale, st);
    case 128: return launch<128, T>(q, k, v, mask, o, B, H, Tlen, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. T must be a multiple of 64; Dh one of
// 16, 32, 64, 128. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* o, int B, int H, int Tlen, int Dh, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tlen <= 0 || Tlen % BQ || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0) return dispatch_dh<__nv_bfloat16>(q, k, v, m, o, B, H, Tlen, Dh, scale, st);
  if (dtype == 1) return dispatch_dh<__half>(q, k, v, m, o, B, H, Tlen, Dh, scale, st);
  return (int)cudaErrorInvalidValue;
}
