// LFM2's gated short convolution, fused into one pass, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package has no LFM2 model. The conv
// layer of the port's LFM2-MoE encoder (models/lfm2_moe.py ShortConv) ran
// the work between its two projections as about fifteen plain-torch
// elementwise passes over (N, h) tensors, many in f32; its plain version,
// ops/short_conv.py::gated_short_conv_plain, keeps that chain.
//
// What it computes. bcx (N, 3h), row-major, holds B, C and X in that order
// of its last dimension (the in-projection's output); w (h, taps) is the
// depthwise weight, the last tap the current token's; pos (N,) int32 is
// each token's place in its text. T is bf16, fp16 or f32, and
// round() rounds to T (the identity in f32). With u_t = round(B_t * X_t),
//
//   v_t = u_t w_{taps-1} + sum_{j=1}^{taps-1} (u_{t-j} [pos_t >= j]) w_{taps-1-j}
//   y_t = round(C_t * round(v_t))                               (N, h) in T
//
// so a token's taps reach only back to its own text's first token. Every
// step is the plain version's, in its order and at its roundings: the
// products in f32, u rounded to T and widened, v summed in f32 one tap at a
// time (u_{t-j} times the 0/1 mask, times the weight, added), v rounded to
// T, the gate's product in f32 rounded to T. Every f32 step is __fmul_rn or
// __fadd_rn, so nvcc contracts none into an FMA, and the output equals the
// plain version's on the card bit for bit (signed zeros and the NaN of
// inf * 0 included).
//
// What bounds it on this card: bytes. B, C and X are read once and y
// written once, 8h bytes a token in bf16 (16h in f32), against about 12
// f32 operations an element: at the LFM2 cell's 46,812 tokens x 2,048,
// 766.9 MB, 0.229 ms at 3.35 TB/s. The chain it replaces moved about 10 GB.
//
// What the design does about it: one read of each input element and one
// write of each output element, in 16-byte vectors. A thread owns VEC
// consecutive channels (8 in bf16 and fp16, 4 in f32; fewer where h or the
// base address is not a multiple of them, down to one)
// for a run of consecutive tokens: a warp reads 512 contiguous bytes of a
// row. The thread keeps u_{t-1} .. u_{t-taps+1} in registers as it walks
// its run, so B and X are read once, plus a halo of taps-1 tokens before
// the run (read by the run before it, so from L2). Its tap weights are
// loaded once. The next token's B, C, X and pos are loaded before the
// current token's arithmetic, so two tokens' loads are in flight a thread.
// Runs are grid x (any N), channel blocks grid y. One launch on the
// caller's stream, no atomics, no host synchronisation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 4;
constexpr int MAX_THREADS = 256;
// consecutive tokens a thread walks: the halo adds (taps-1)/32 to B and
// X's reads (from L2); runs of 8-128 timed within 5 % of each other on an
// H100 at the LFM2 cell's shape, 32 the fastest
constexpr int RUN = 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) { return __float2half_rn(x); }

// x as the plain version's tensor of dtype T holds it, widened again
template <typename T>
__device__ __forceinline__ float round_to(float x) { return widen(narrow<T>(x)); }

template <int BYTES>
struct RawOf;
template <>
struct RawOf<2> { using type = unsigned short; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<16> { using type = uint4; };

// VEC consecutive elements of T as one load or store
template <typename T, int VEC>
struct Pack {
  using Raw = typename RawOf<sizeof(T) * VEC>::type;
  Raw raw;

  __device__ __forceinline__ void load(const T* p) { raw = __ldg(reinterpret_cast<const Raw*>(p)); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<Raw*>(p) = raw; }
  __device__ __forceinline__ float get(int i) const { return widen(reinterpret_cast<const T*>(&raw)[i]); }
  __device__ __forceinline__ void set(int i, float x) { reinterpret_cast<T*>(&raw)[i] = narrow<T>(x); }
};

template <typename T, int VEC, int TAPS>
__global__ void __launch_bounds__(MAX_THREADS)
    short_conv_kernel(const T* __restrict__ bcx, const T* __restrict__ w,
                      const int* __restrict__ pos, T* __restrict__ y, long long n, int h) {
  using P = Pack<T, VEC>;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= h) return;
  const long long t0 = (long long)blockIdx.x * RUN;
  const long long t1 = min(t0 + RUN, n);
  const long long ld = 3LL * h;
  const T* col = bcx + c0;

  float wt[TAPS][VEC];
#pragma unroll
  for (int j = 0; j < TAPS; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) wt[j][e] = widen(w[(long long)(c0 + e) * TAPS + j]);

  // prev[j - 1] = u_{t-j}; a token before the first is 0 (the plain
  // version's pad), and its mask is 0 too
  float prev[TAPS > 1 ? TAPS - 1 : 1][VEC];
#pragma unroll
  for (int j = 1; j < TAPS; ++j) {
    const long long t = t0 - j;
    P b = {}, x = {};
    if (t >= 0) {
      b.load(col + t * ld);
      x.load(col + t * ld + 2 * h);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      prev[j - 1][e] = t >= 0 ? round_to<T>(__fmul_rn(b.get(e), x.get(e))) : 0.0f;
  }

  P nb, nc, nx;
  int np = 0;
  if (t0 < t1) {
    nb.load(col + t0 * ld);
    nc.load(col + t0 * ld + h);
    nx.load(col + t0 * ld + 2 * h);
    np = __ldg(pos + t0);
  }
  for (long long t = t0; t < t1; ++t) {
    const P b = nb, c = nc, x = nx;
    const int p = np;
    if (t + 1 < t1) {
      const T* row = col + (t + 1) * ld;
      nb.load(row);
      nc.load(row + h);
      nx.load(row + 2 * h);
      np = __ldg(pos + t + 1);
    }
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float u = round_to<T>(__fmul_rn(b.get(e), x.get(e)));
      float v = __fmul_rn(u, wt[TAPS - 1][e]);
#pragma unroll
      for (int j = 1; j < TAPS; ++j) {
        const float keep = p >= j ? 1.0f : 0.0f;
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(prev[j - 1][e], keep), wt[TAPS - 1 - j][e]));
      }
      out.set(e, __fmul_rn(c.get(e), round_to<T>(v)));
#pragma unroll
      for (int j = TAPS - 1; j > 1; --j) prev[j - 1][e] = prev[j - 2][e];
      if (TAPS > 1) prev[0][e] = u;
    }
    out.store(y + t * h + c0);
  }
}

template <typename T, int VEC>
int launch_vec(const void* bcx, const void* w, const void* pos, void* y, long long n, int h,
               int taps, cudaStream_t st) {
  // a block covers up to MAX_THREADS vectors of a row: at most one partial warp
  const int per_row = h / VEC;
  const int threads = per_row < MAX_THREADS ? (per_row + 31) / 32 * 32 : MAX_THREADS;
  const long long runs = (n + RUN - 1) / RUN;
  const long long blocks = (per_row + threads - 1) / threads;
  if (runs > 0x7fffffffLL || blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)runs, (unsigned)blocks);
  const T* b = static_cast<const T*>(bcx);
  const T* wt = static_cast<const T*>(w);
  const int* ps = static_cast<const int*>(pos);
  T* out = static_cast<T*>(y);
#define SHORT_CONV_RUN(TAPS) \
  short_conv_kernel<T, VEC, TAPS><<<grid, threads, 0, st>>>(b, wt, ps, out, n, h)
  switch (taps) {
    case 1: SHORT_CONV_RUN(1); break;
    case 2: SHORT_CONV_RUN(2); break;
    case 3: SHORT_CONV_RUN(3); break;
    case 4: SHORT_CONV_RUN(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SHORT_CONV_RUN
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* bcx, const void* w, const void* pos, void* y, long long n, int h,
           int taps, int vec, cudaStream_t st) {
  constexpr int MAX_VEC = 16 / (int)sizeof(T);
  if (vec > MAX_VEC) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, 1>(bcx, w, pos, y, n, h, taps, st);
    case 2: return launch_vec<T, 2>(bcx, w, pos, y, n, h, taps, st);
    case 4: return launch_vec<T, 4>(bcx, w, pos, y, n, h, taps, st);
    case 8:
      return launch_vec<T, (MAX_VEC >= 8 ? 8 : 1)>(bcx, w, pos, y, n, h, taps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y (n, h) = the gated short convolution of bcx (n, 3h) with w (h, taps)
// over texts whose places are pos (n,) int32. dtype: 0 bf16, 1 fp16, 2 f32.
// vec: channels a thread (h a multiple of it, bcx aligned to vec elements).
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// out of range).
extern "C" int gated_short_conv(const void* bcx, const void* w, const void* pos, void* y,
                                long long n, int h, int taps, int dtype, int vec,
                                void* stream) {
  if (n <= 0 || h <= 0 || taps < 1 || taps > MAX_TAPS || vec <= 0 || h % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(bcx, w, pos, y, n, h, taps, vec, st);
    case 1: return launch<__half>(bcx, w, pos, y, n, h, taps, vec, st);
    case 2: return launch<float>(bcx, w, pos, y, n, h, taps, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
