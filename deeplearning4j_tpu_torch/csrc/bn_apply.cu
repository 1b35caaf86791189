// BatchNorm apply (+ReLU) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_apply_kernel` launched by `_apply` in
// deeplearning4j_tpu/ops/pallas_bn.py: y[m, c] = act(x[m, c] * scale[c] +
// shift[c]) over the channels-last [M, C] view of an [..., C] tensor, with
// act identity or relu, x, scale, shift and y all float32 or all bfloat16.
//
// What bounds it.  One multiply-add per element against 2 * itemsize
// bytes moved: far below the card's ~20 FLOP/byte f32 balance point, so
// the bytes bound it (x read once, y written once; scale and shift are
// 2 * C more).  The design moves nothing else: no lane folding and no
// tiling as the TPU kernel's (8, 128) VMEM blocks need, just a
// grid-stride loop over 16-byte vectors (4 f32 or 8 bf16 elements, all
// in one row because C is a multiple of the vector width) with enough
// blocks resident to keep loads in flight on every SM.  Shapes whose C is
// not a multiple of the vector width, or pointers not 16-byte aligned,
// take the same loop one element at a time.
//
// Scale and shift.  Each block stages both as f32 in shared memory (8
// bytes per channel: 16 KB at C = 2048; above 48 KB the launch asks for
// the larger dynamic allowance, up to the 227 KB a block may have).  A
// thread reads its vector's channels as 16-byte shared loads, which are
// free of bank conflicts.  Its channel index advances by the grid stride
// modulo the row's vector count each iteration, so the loop divides once.
//
// Arithmetic.  f32 FMA (one rounding); bf16 is widened to f32 on load
// and rounded once to nearest-even on store.  relu keeps NaN as NaN, as
// jnp.maximum and torch.relu do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

struct Bf16x8 {
  using T = __nv_bfloat16;
  using V = uint4;
  static constexpr int N = 8;
  __device__ static void unpack(const V& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static V pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
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

struct Bf16x1 {
  using T = __nv_bfloat16;
  using V = __nv_bfloat16;
  static constexpr int N = 1;
  __device__ static void unpack(const V& v, float* f) { f[0] = __bfloat162float(v); }
  __device__ static V pack(const float* f) { return __float2bfloat16(f[0]); }
};

// N consecutive f32 from shared memory (16-byte loads when N % 4 == 0).
template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* f) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      f[i] = q.x; f[i + 1] = q.y; f[i + 2] = q.z; f[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = p[i];
  }
}

template <class P, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const typename P::V* __restrict__ x,
                const typename P::T* __restrict__ scale,
                const typename P::T* __restrict__ shift,
                typename P::V* __restrict__ y, long long n_vec, int c) {
  extern __shared__ __align__(16) float smem[];
  float* s_scale = smem;
  float* s_shift = smem + c;  // c % N == 0 keeps 16-byte alignment
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_scale[i] = to_f32(scale[i]);
    s_shift[i] = to_f32(shift[i]);
  }
  __syncthreads();

  const long long row_vecs = c / P::N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long step = stride % row_vecs;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long cv = v % row_vecs;  // this vector's place in its row
  for (; v < n_vec; v += stride) {
    float f[P::N], sc[P::N], sh[P::N];
    P::unpack(x[v], f);
    load_smem<P::N>(s_scale + cv * P::N, sc);
    load_smem<P::N>(s_shift + cv * P::N, sh);
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      const float r = fmaf(f[i], sc[i], sh[i]);
      f[i] = (RELU && r < 0.f) ? 0.f : r;
    }
    y[v] = P::pack(f);
    cv += step;
    if (cv >= row_vecs) cv -= row_vecs;
  }
}

template <class P, bool RELU>
int launch_act(const void* x, const void* scale, const void* shift, void* y,
           long long n, int c, cudaStream_t stream) {
  const long long n_vec = n / P::N;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  const size_t smem = 2 * (size_t)c * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)bn_apply_kernel<P, RELU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bn_apply_kernel<P, RELU><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const typename P::V*>(x),
      static_cast<const typename P::T*>(scale),
      static_cast<const typename P::T*>(shift),
      static_cast<typename P::V*>(y), n_vec, c);
  return (int)cudaGetLastError();
}

template <class P>
int launch(const void* x, const void* scale, const void* shift, void* y,
           long long n, int c, int relu, cudaStream_t stream) {
  return relu ? launch_act<P, true>(x, scale, shift, y, n, c, stream)
              : launch_act<P, false>(x, scale, shift, y, n, c, stream);
}

}  // namespace

// x, y: [m, c] contiguous; scale, shift: [c]; all of one dtype
// (0 float32, 1 bfloat16).  Returns a cudaError_t (0 on success).
extern "C" int bn_apply(const void* x, const void* scale, const void* shift,
                        void* y, long long m, int c, int relu, int dtype,
                        void* stream) {
  if (m < 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long long n = m * (long long)c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (dtype == 0) {
    if (aligned && c % F32x4::N == 0)
      return launch<F32x4>(x, scale, shift, y, n, c, relu, s);
    return launch<F32x1>(x, scale, shift, y, n, c, relu, s);
  }
  if (dtype == 1) {
    if (aligned && c % Bf16x8::N == 0)
      return launch<Bf16x8>(x, scale, shift, y, n, c, relu, s);
    return launch<Bf16x1>(x, scale, shift, y, n, c, relu, s);
  }
  return (int)cudaErrorInvalidValue;
}
