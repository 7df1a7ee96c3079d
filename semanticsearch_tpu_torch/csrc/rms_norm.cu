// RMSNorm, with or without the residual add before it, in one pass, for
// Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package has no LFM2 model. The port's
// LFM2-MoE encoder (models/lfm2_moe.py) ran each residual add and the
// RMSNorm after it as seven plain-torch passes over (N, h) tensors, several
// in f32; the plain version, ops/rms_norm.py::add_rms_norm_plain, keeps
// that chain.
//
// What it computes, a row of width h at a time. T is bf16, fp16 or f32 and
// round() rounds to T (the identity in f32). With d (the residual's update)
// or without it (s = x):
//
//   s   = round(x + d)                                   (N, h) in T
//   ms  = (sum of float(s)^2 over the row) / h           f32
//   r   = rsqrtf(ms + eps)
//   out = round(float(round(float(s) * r)) * float(w))   (N, h) in T
//
// Each step is the plain chain's, at its roundings and in its order; only
// the order of the sum of squares differs (each lane's elements in turn,
// then a butterfly of warp shuffles). Every f32 step is __fadd_rn,
// __fmul_rn or __fdiv_rn, so nvcc contracts none into an FMA: s is the
// plain add's bits, and out differs from the plain chain's only where the
// sum's order moves r across a rounding of round(float(s) * r).
//
// What bounds it on this card: bytes. x and d are read once and s and out
// written once, 8 bytes an element in bf16 (4 without the add), against
// about 5 f32 operations an element: at the LFM2 cell's 48,637 tokens x
// 2,048, 796.9 MB, 0.238 ms at 3.35 TB/s. The chain it replaces moved about
// 40 bytes an element.
//
// What the design does about it: each element is read once and written
// once, in 16-byte vectors, and the row stays in registers between the
// statistic and the output, so no shared memory and no __syncthreads. A row
// is `lanes` consecutive lanes of a warp (a power of two up to 32), each
// holding NV (1 or 8) vectors of VEC elements: at h 2,048 in bf16 a warp a
// row, each lane eight 16-byte vectors of x and eight of d, all loaded
// before the first is used; at h 64 (the attention's q/k norms over each
// head) 8 lanes a row, four rows a warp, one vector a lane. A row of more
// than 32 vectors and at most 32 * 8 takes NV 8 with the vectors past its
// end left out; a row wider than 32 * 8 vectors takes the
// loop path: a warp a row, which reads x and d again (from L2) for the
// output. The weight goes through the read-only path. One launch on the
// caller's stream, no atomics, no host synchronisation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// s = round(x + d) into a, in place (ADD), and the sum of its squares
template <typename T, int VEC, bool ADD>
__device__ __forceinline__ float residual(Pack<T, VEC>& a, const Pack<T, VEC>& d) {
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (ADD) a.set(e, __fadd_rn(a.get(e), d.get(e)));
    const float s = a.get(e);
    acc = __fadd_rn(acc, __fmul_rn(s, s));
  }
  return acc;
}

// out = round(round(s * r) * w)
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> normed(const Pack<T, VEC>& s, const Pack<T, VEC>& w,
                                               float r) {
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    o.set(e, __fmul_rn(widen(narrow<T>(__fmul_rn(s.get(e), r))), w.get(e)));
  return o;
}

// the sum over a row's `lanes` aligned lanes; every lane of the group gets
// the same bits (each step adds the same two partial sums, in either order)
__device__ __forceinline__ float row_sum(float acc, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  return acc;
}

__device__ __forceinline__ float inv_rms(float sum, int h, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(sum, (float)h), eps));
}

// `lanes` lanes a row, each holding vectors lane, lane + lanes, ... (NV of
// them, those past the row's end left out). No lane returns early: a row
// past the last still takes part in its warp's shuffles.
template <typename T, int VEC, int NV, bool ADD>
__global__ void __launch_bounds__(THREADS)
    rms_norm_regs(const T* __restrict__ x, const T* __restrict__ d, const T* __restrict__ w,
                  T* __restrict__ s, T* __restrict__ out, long long rows, int h, int lanes,
                  float eps) {
  using P = Pack<T, VEC>;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int per_row = h / VEC;
  const bool live = row < rows;
  const long long base = row * h;

  P a[NV], b[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * lanes + lane;
    if (live && v < per_row) {
      a[j].load(x + base + v * VEC);
      if (ADD) b[j].load(d + base + v * VEC);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * lanes + lane;
    if (live && v < per_row) {
      acc = __fadd_rn(acc, residual<T, VEC, ADD>(a[j], b[j]));
      if (ADD) a[j].store(s + base + v * VEC);
    }
  }
  const float r = inv_rms(row_sum(acc, lanes), h, eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * lanes + lane;
    if (live && v < per_row) {
      P wv;
      wv.load(w + v * VEC);
      normed<T, VEC>(a[j], wv, r).store(out + base + v * VEC);
    }
  }
}

// a warp a row, any width: the statistic from a first pass that writes s,
// the output from a second that reads x and d again
template <typename T, int VEC, bool ADD>
__global__ void __launch_bounds__(THREADS)
    rms_norm_loop(const T* __restrict__ x, const T* __restrict__ d, const T* __restrict__ w,
                  T* __restrict__ s, T* __restrict__ out, long long rows, int h, float eps) {
  using P = Pack<T, VEC>;
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp: one row
  const int per_row = h / VEC;
  const long long base = row * h;
  float acc = 0.0f;
#pragma unroll 4
  for (int v = lane; v < per_row; v += 32) {
    P a, b;
    a.load(x + base + v * VEC);
    if (ADD) b.load(d + base + v * VEC);
    acc = __fadd_rn(acc, residual<T, VEC, ADD>(a, b));
    if (ADD) a.store(s + base + v * VEC);
  }
  const float r = inv_rms(row_sum(acc, 32), h, eps);
#pragma unroll 4
  for (int v = lane; v < per_row; v += 32) {
    P a, b, wv;
    a.load(x + base + v * VEC);
    if (ADD) b.load(d + base + v * VEC);
    residual<T, VEC, ADD>(a, b);
    wv.load(w + v * VEC);
    normed<T, VEC>(a, wv, r).store(out + base + v * VEC);
  }
}

template <typename T, int VEC, bool ADD>
int launch_vec(const void* x, const void* d, const void* w, void* s, void* out, long long rows,
               int h, float eps, int lanes, int nv, cudaStream_t st) {
  const long long threads = rows * (nv ? lanes : 32);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(d);
  const T* wp = static_cast<const T*>(w);
  T* sp = static_cast<T*>(s);
  T* op = static_cast<T*>(out);
  const unsigned grid = (unsigned)blocks;
#define RMS_NORM_REGS(NV) \
  rms_norm_regs<T, VEC, NV, ADD><<<grid, THREADS, 0, st>>>(xp, dp, wp, sp, op, rows, h, lanes, eps)
  switch (nv) {
    case 0: rms_norm_loop<T, VEC, ADD><<<grid, THREADS, 0, st>>>(xp, dp, wp, sp, op, rows, h, eps); break;
    case 1: RMS_NORM_REGS(1); break;
    case 8: RMS_NORM_REGS(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RMS_NORM_REGS
  return (int)cudaGetLastError();
}

template <typename T, bool ADD>
int launch(const void* x, const void* d, const void* w, void* s, void* out, long long rows, int h,
           float eps, int vec, int lanes, int nv, cudaStream_t st) {
  constexpr int MAX_VEC = 16 / (int)sizeof(T);
  if (vec > MAX_VEC) return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 1: return launch_vec<T, 1, ADD>(x, d, w, s, out, rows, h, eps, lanes, nv, st);
    case 2: return launch_vec<T, 2, ADD>(x, d, w, s, out, rows, h, eps, lanes, nv, st);
    case 4: return launch_vec<T, 4, ADD>(x, d, w, s, out, rows, h, eps, lanes, nv, st);
    case 8:
      return launch_vec<T, (MAX_VEC >= 8 ? 8 : 1), ADD>(x, d, w, s, out, rows, h, eps, lanes, nv,
                                                         st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_dtype(const void* x, const void* d, const void* w, void* s, void* out,
                 long long rows, int h, float eps, int vec, int lanes, int nv, cudaStream_t st) {
  return d ? launch<T, true>(x, d, w, s, out, rows, h, eps, vec, lanes, nv, st)
           : launch<T, false>(x, d, w, s, out, rows, h, eps, vec, lanes, nv, st);
}

}  // namespace

// out (rows, h) = RMSNorm(x + d) * w, and s (rows, h) = x + d; with d NULL,
// out = RMSNorm(x) * w and s is not written. w is (h,). dtype: 0 bf16, 1
// fp16, 2 f32. vec: elements a vector (h a multiple of it, every pointer
// aligned to vec elements); lanes: lanes a row (a power of two up to 32);
// nv: vectors a lane holds (1 or 8, lanes * nv * vec >= h; ops/rms_norm.py
// MAX_VECTORS), or 0 for the loop path (a warp a row). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int rms_norm(const void* x, const void* d, const void* w, void* s, void* out,
                        long long rows, int h, float eps, int dtype, int vec, int lanes, int nv,
                        void* stream) {
  if (rows <= 0 || h <= 0 || vec <= 0 || h % vec || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || (nv && (long long)lanes * nv * vec < h) || (d && !s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dtype<__nv_bfloat16>(x, d, w, s, out, rows, h, eps, vec, lanes, nv, st);
    case 1: return launch_dtype<__half>(x, d, w, s, out, rows, h, eps, vec, lanes, nv, st);
    case 2: return launch_dtype<float>(x, d, w, s, out, rows, h, eps, vec, lanes, nv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
