// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_kernel` launched by `_flash_fwd_call`
// in deeplearning4j_tpu/ops/flash_attention.py: causal or full
// online-softmax attention over [b*h, t, d], writing O (input dtype) and
// the per-row logsumexp (f32, [b*h, t]).
//
// Work split.  One CTA per (b*h, 64-row q-tile); the TPU kernel's
// sequential key-block grid axis becomes a loop inside the CTA, which
// carries the running max m, row sum l and the O accumulator in
// registers (f32).  Under `causal` the loop stops at the diagonal tile;
// that is `_block_live`'s skip.  Ragged edges (t not a multiple of 64)
// load zeros and mask the scores, so every t the wrapper's `supports`
// rule admits runs here.
//
// Arithmetic.  Q, K, V tiles are staged in shared memory as f32 (bf16 is
// widened on load, as the TPU kernel widens to f32) and both products
// run as f32 FMAs on the CUDA cores.  The f32 path deliberately does not
// use TF32 tensor cores: at the serving shape TF32 would lose about three
// decimal digits against the f32 reference.  wgmma, TMA and warp
// specialisation are later work.
//
// What bounds it.  At the serving shape ([128, 512, 64], causal) the
// work is ~4.3 GFLOP.  In f32 that is ~64 us at the card's 67 TFLOP/s of
// non-tensor f32 against ~20 us to move q/k/v/o (67 MB), so operations
// bound it, and the design keeps every operand in shared memory or
// registers so that the FMA pipes are the only limit.  In bf16 the bytes
// bound it (34 MB, ~10 us, against ~4 us of bf16 tensor-core work); this
// version leaves the tensor cores idle and does not reach that bound.
//
// Blocks.  BLOCK_Q = BLOCK_K = 64 with 256 threads: each thread owns a
// 4x4 patch of the 64x64 score tile (rows ty+16i, cols tx+16j) and a
// 4 x d/16 patch of O.  Staging Q, K, V (padded rows to dodge bank
// conflicts) plus the P tile in f32 takes ~66 KB at d=64 (three CTAs per
// SM) and ~115 KB at d=128 (one), inside the 227 KB a block may use;
// larger tiles would cut the CTAs per SM at d=64 without cutting loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;  // finite, as in ops/attention.NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy rows [row0, row0+64) of a [t, D] matrix into an f32 tile with row
// stride `ld`; rows past t read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int t) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + c] = row < t ? to_f32(src[(int64_t)row * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_q, int t_k, int causal,
                 float scale) {
  constexpr int LDQ = D + 1;   // +1 word: lanes tx read distinct banks
  constexpr int LDP = BK + 1;
  constexpr int DJ = D / 16;   // O columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LDQ]
  float* sK = sQ + BQ * LDQ;        // [BK][LDQ]
  float* sV = sK + BK * LDQ;        // [BK][D]
  float* sP = sV + BK * D;          // [BQ][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* qb = q + (int64_t)bh * t_q * D;
  const T* kb = k + (int64_t)bh * t_k * D;
  const T* vb = v + (int64_t)bh * t_k * D;

  load_tile<T, D>(sQ, LDQ, qb, q0, t_q);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (t_k + BK - 1) / BK;
  if (causal) {
    // last key tile with any key <= the tile's last query row
    const int live = (min(q0 + BQ, t_q) - 1) / BK + 1;
    n_kt = min(n_kt, live);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous iteration done with sK/sV/sP
    load_tile<T, D>(sK, LDQ, kb, k0, t_k);
    load_tile<T, D>(sV, D, vb, k0, t_k);
    __syncthreads();

    // S = scale * Q K^T on this thread's 4x4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LDQ + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LDQ + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= t_k || (causal && qpos < kpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes that share a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > NEG_INF * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V on this thread's 4 x D/16 patch
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], b[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) b[j] = sV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }

  T* ob = o + (int64_t)bh * t_q * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_q) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully-masked row -> zeros
    const float inv = 1.f / li;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      from_f32(&ob[(int64_t)row * D + tx + 16 * j], acc[i][j] * inv);
    if (tx == 0) lse[(int64_t)bh * t_q + row] = m[i] + logf(li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int t_q, int t_k, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t_q, t_k, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64 or 128.  All tensors contiguous
// [bh, t, d] (lse [bh, t_q]).  Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int t_q, int t_k,
                              int d, int causal, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t_q <= 0 || t_k <= 0 || (t_q + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && d == 64)
    return (int)launch<float, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  if (dtype == 0 && d == 128)
    return (int)launch<float, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
