// BatchNorm apply (+ReLU) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_apply_kernel` launched by `_apply` in
// deeplearning4j_tpu/ops/pallas_bn.py: y[m, c] = act(x[m, c] * scale[c] +
// shift[c]) over the channels-last [M, C] view of an [..., C] tensor, with
// act identity or relu, x, scale, shift and y all float32, all bfloat16 or
// all float16.
//
// What bounds it.  One multiply-add per element against 2 * itemsize
// bytes moved: far below the card's ~20 FLOP/byte f32 balance point, so
// the bytes bound it (x read once, y written once; scale and shift are
// 2 * C more).  The design moves nothing else and keeps enough loads in
// flight to reach the memory rate:
//
// - A grid-stride loop over 16-byte vectors (4 f32 or 8 bf16/f16 elements,
//   all in one row because C is a multiple of the vector width); shapes
//   whose C is not, or pointers not 16-byte aligned, take the same loop
//   one element at a time.
// - Each thread issues UNROLL = 4 independent vector loads before it
//   computes and stores any of them: 64 bytes in flight per thread.  The
//   last round is predicated, not a one-vector-at-a-time tail.
// - The launch is planned on the host (`ops/pallas_bn.plan`) and passed
//   in as plain ints: the vector width, the grid (whole waves of resident
//   blocks, fewer for small tensors so each thread still has UNROLL
//   vectors) and whether the grid stride is a multiple of the row's
//   vector count.  When it is (every ResNet50
//   geometry), each thread's channels are the same for its whole loop: it
//   reads its scale and shift once, into registers, through the read-only
//   path.  Otherwise (large C that no resident grid divides) the channel
//   index rolls by the grid stride modulo the row's vector count, and
//   scale and shift are read per vector through the read-only cache.
//   Either way there is no shared-memory staging and no block barrier.
// - x is read through the read-only path with the default cache policy:
//   the evict-first hint (`__ldcs`) measured within 2.5 % of it at every
//   ResNet50 geometry of >= 50 MB (the tensors outsize L2, so the hint has
//   nothing to protect).  y is stored with the default policy: the next
//   convolution reads it.
//
// Arithmetic.  f32 FMA (one rounding); bf16 and f16 are widened to f32 on
// load and rounded once to nearest-even on store (f16 to +-inf past
// 65504, as torch's f32 -> f16 conversion).  relu keeps NaN as NaN, as
// jnp.maximum and torch.relu do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;  // <= 64 registers a thread: 1024 per SM

// One 16-byte (or one-element) vector of x/y and its f32 lanes.
struct F32x4 {
  using T = float;
  using V = float4;
  static constexpr int N = 4;
  __device__ static void unpack(const V& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static V pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};

// The two 16-bit types' pair conversions, widened to f32 and back.
struct Bf16Ops {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  __device__ static float2 widen2(const T2& h) { return __bfloat1622float2(h); }
  __device__ static T2 narrow2(float a, float b) { return __floats2bfloat162_rn(a, b); }
  __device__ static float widen(const T& h) { return __bfloat162float(h); }
  __device__ static T narrow(float a) { return __float2bfloat16(a); }
};

struct F16Ops {
  using T = __half;
  using T2 = __half2;
  __device__ static float2 widen2(const T2& h) { return __half22float2(h); }
  __device__ static T2 narrow2(float a, float b) { return __floats2half2_rn(a, b); }
  __device__ static float widen(const T& h) { return __half2float(h); }
  __device__ static T narrow(float a) { return __float2half_rn(a); }
};

template <class Ops>
struct Half16x8 {
  using T = typename Ops::T;
  using V = uint4;
  static constexpr int N = 8;
  __device__ static void unpack(const V& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = Ops::widen2(*reinterpret_cast<const typename Ops::T2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static V pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const typename Ops::T2 h = Ops::narrow2(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct F32x1 {
  using T = float;
  using V = float;
  static constexpr int N = 1;
  __device__ static void unpack(const V& v, float* f) { f[0] = v; }
  __device__ static V pack(const float* f) { return f[0]; }
};

template <class Ops>
struct Half16x1 {
  using T = typename Ops::T;
  using V = typename Ops::T;
  static constexpr int N = 1;
  __device__ static void unpack(const V& v, float* f) { f[0] = Ops::widen(v); }
  __device__ static V pack(const float* f) { return Ops::narrow(f[0]); }
};

// The N f32 lanes of scale or shift for row vector cv.
template <class P>
__device__ __forceinline__ void load_param(const typename P::T* p, long long cv, float* f) {
  P::unpack(__ldg(reinterpret_cast<const typename P::V*>(p) + cv), f);
}

template <class P, bool RELU>
__device__ __forceinline__ typename P::V apply(const typename P::V& xv,
                                               const float* sc, const float* sh) {
  float f[P::N];
  P::unpack(xv, f);
#pragma unroll
  for (int i = 0; i < P::N; ++i) {
    const float r = fmaf(f[i], sc[i], sh[i]);
    f[i] = (RELU && r < 0.f) ? 0.f : r;
  }
  return P::pack(f);
}

template <class P, bool RELU, bool FIXED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_apply_kernel(const typename P::V* __restrict__ x,
                const typename P::T* __restrict__ scale,
                const typename P::T* __restrict__ shift,
                typename P::V* __restrict__ y, long long n_vec, int c) {
  const long long row_vecs = c / P::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long cv = v % row_vecs;   // this vector's place in its row
  const long long step = stride % row_vecs;   // 0 when FIXED
  float sc[P::N], sh[P::N];
  if constexpr (FIXED) {
    load_param<P>(scale, cv, sc);
    load_param<P>(shift, cv, sh);
  }
  // kUnroll vectors per round, all loads issued before any store; the
  // last round is predicated rather than a one-at-a-time tail, so a
  // thread with few vectors still waits on memory once per round
  for (; v < n_vec; v += kUnroll * stride) {
    typename P::V xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * stride < n_vec) xv[u] = __ldg(x + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (!FIXED) {
        load_param<P>(scale, cv, sc);
        load_param<P>(shift, cv, sh);
        cv += step;
        if (cv >= row_vecs) cv -= row_vecs;
      }
      if (v + u * stride < n_vec) y[v + u * stride] = apply<P, RELU>(xv[u], sc, sh);
    }
  }
}

template <class P, bool RELU, bool FIXED>
int launch3(const void* x, const void* scale, const void* shift, void* y,
            long long n_vec, int c, int grid, cudaStream_t stream) {
  bn_apply_kernel<P, RELU, FIXED><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const typename P::V*>(x),
      static_cast<const typename P::T*>(scale),
      static_cast<const typename P::T*>(shift),
      static_cast<typename P::V*>(y), n_vec, c);
  return (int)cudaGetLastError();
}

template <class P, bool RELU>
int launch2(const void* x, const void* scale, const void* shift, void* y,
            long long n_vec, int c, int grid, int fixed, cudaStream_t s) {
  return fixed ? launch3<P, RELU, true>(x, scale, shift, y, n_vec, c, grid, s)
               : launch3<P, RELU, false>(x, scale, shift, y, n_vec, c, grid, s);
}

template <class P>
int launch(const void* x, const void* scale, const void* shift, void* y,
           long long m, int c, int relu, int grid, int fixed, cudaStream_t s) {
  const long long row_vecs = c / P::N;
  // a fixed-channel plan needs a stride that is a whole number of rows
  if (fixed && ((long long)grid * kThreads) % row_vecs != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_vec = m * row_vecs;
  return relu ? launch2<P, true>(x, scale, shift, y, n_vec, c, grid, fixed, s)
              : launch2<P, false>(x, scale, shift, y, n_vec, c, grid, fixed, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, y: [m, c] contiguous; scale, shift: [c]; all of one dtype (0 float32,
// 1 bfloat16, 2 float16).  The launch plan (ops/pallas_bn.plan): vec (16 /
// itemsize, or 1), grid (blocks of kThreads) and fixed (the grid stride is
// a multiple of c / vec).  Returns a cudaError_t (0 on success).
extern "C" int bn_apply(const void* x, const void* scale, const void* shift,
                        void* y, long long m, int c, int relu, int dtype,
                        int vec, int grid, int fixed, void* stream) {
  if (m < 0 || c <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wide = dtype == 0 ? F32x4::N : Half16x8<Bf16Ops>::N;
  if (vec == wide && (c % wide != 0 || !aligned16(x) || !aligned16(y) ||
                      !aligned16(scale) || !aligned16(shift)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == F32x4::N)
      return launch<F32x4>(x, scale, shift, y, m, c, relu, grid, fixed, s);
    if (vec == 1)
      return launch<F32x1>(x, scale, shift, y, m, c, relu, grid, fixed, s);
  }
  if (dtype == 1) {
    if (vec == wide)
      return launch<Half16x8<Bf16Ops>>(x, scale, shift, y, m, c, relu, grid, fixed, s);
    if (vec == 1)
      return launch<Half16x1<Bf16Ops>>(x, scale, shift, y, m, c, relu, grid, fixed, s);
  }
  if (dtype == 2) {
    if (vec == wide)
      return launch<Half16x8<F16Ops>>(x, scale, shift, y, m, c, relu, grid, fixed, s);
    if (vec == 1)
      return launch<Half16x1<F16Ops>>(x, scale, shift, y, m, c, relu, grid, fixed, s);
  }
  return (int)cudaErrorInvalidValue;
}
