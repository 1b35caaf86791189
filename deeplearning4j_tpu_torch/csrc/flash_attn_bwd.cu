// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas kernels that `_flash_bwd` launches in
// deeplearning4j_tpu/ops/flash_attention.py:
//   `_flash_bwd_dq_kernel`  -> flash_bwd_dq_kernel  (dq)
//   `_flash_bwd_dkv_kernel` -> flash_bwd_dkv_kernel (dk, dv)
// Both replay the softmax block from the forward's logsumexp, as
// `_replay_p_ds` does:
//   S  = scale * Q K^T, causal positions above the diagonal -> NEG_INF
//   P  = exp(S - lse) where S > NEG_INF/2, else 0
//   dP = dO V^T
//   dS = P * (dP - D) * scale,      D = rowsum(dO * O), computed outside
// and accumulate dq = dS K, dk = dS^T Q, dv = P^T dO in f32.
//
// Work split.  The TPU kernels carry their accumulators in VMEM scratch
// across a sequential grid axis.  CUDA blocks run in no order, so each
// block owns one output tile and walks the other axis in a loop:
//   dq:  one CTA per (b*h, 64-row q tile), looping over k tiles up to the
//        causal diagonal;
//   dkv: one CTA per (b*h, 64-row k tile), looping over q tiles from the
//        diagonal to the end (`_block_live` seen from the k side).  It
//        reads lse and D of the q tile it visits, not of its own k tile.
// No block writes another's output, so there are no atomics and the
// results are the same from run to run.
//
// Arithmetic.  Tiles are staged in shared memory as f32 (bf16 widens on
// load, as the TPU kernels' `.astype(jnp.float32)`) and every product is
// an f32 FMA on the CUDA cores: TF32 would lose about three decimal
// digits at head_dim 64.  wgmma, TMA and warp specialisation are later
// work.  Ragged tiles (t not a multiple of 64) load zero rows; masked or
// out-of-range positions give P = 0 and dS = 0, and rows past t are
// never written.  A fully masked row has lse = NEG_INF; the select on
// S > NEG_INF/2 keeps its P at 0, not exp(0) = 1.
//
// What bounds it.  Per live (q, k) pair the dq kernel does 6*d
// operations (S, dP, dS K) and the dk/dv kernel 8*d (S, dP, P^T dO,
// dS^T Q).  At the training shape ([128, 512, 64], causal, f32) that is
// ~6.5 and ~8.6 GFLOP, ~0.10 and ~0.13 ms at the 67 TFLOP/s non-tensor
// f32 rate, against ~0.025 ms to move the bytes: operations bound both,
// and the design keeps every operand in shared memory or registers so
// that the FMA pipes are the only limit.
//
// Blocks.  64x64 tiles, 256 threads: each thread owns a 4x4 patch of the
// 64x64 score tile (rows ty+16i, cols tx+16j) and a 4 x d/16 patch of
// its output tile.  Rows are padded by one word so that the 16 lanes
// sharing a row read distinct banks.  Shared memory: dq ~83 KB at d=64,
// ~149 KB at d=128; dk/dv ~100 KB and ~166 KB; all inside the 227 KB a
// block may use.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;     // q and k tile rows
constexpr int NT = 256;    // threads per block
constexpr int LDP = BT + 1;
constexpr float NEG_INF = -1e30f;  // finite, as in ops/attention.NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy rows [row0, row0+64) of a [t, D] matrix into an f32 tile with row
// stride D+1; rows past t read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t) {
  for (int idx = threadIdx.x; idx < BT * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < t ? to_f32(src[(int64_t)row * D + c]) : 0.f;
  }
}

// acc[i][j] += sum_kk A[ty+16i][kk] * B[tx+16j][kk]: the 4x4 patch of a
// 64x64 product of two row-major [64][D] tiles (row stride D+1), the
// second one transposed.
template <int D>
__device__ __forceinline__ void patch_abt(float (&acc)[4][4], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_kk P[ty+16i][kk] * B[kk][tx+16j]: a [64][64] tile
// (row stride LDP) times a row-major [64][D] tile (row stride D+1), onto
// this thread's 4 x D/16 patch.
template <int D>
__device__ __forceinline__ void patch_pb(float (&acc)[4][D / 16],
                                         const float* P, const float* B,
                                         int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < BT; ++kk) {
    float p[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * LDP + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[kk * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    T* __restrict__ dq, int t_q, int t_k, int causal,
                    float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;              // [64][LD]
  float* sO = sQ + BT * LD;      // dO tile [64][LD]
  float* sK = sO + BT * LD;      // [64][LD]
  float* sV = sK + BT * LD;      // [64][LD]
  float* sS = sV + BT * LD;      // dS tile [64][LDP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t qoff = (int64_t)bh * t_q * D;
  const int64_t koff = (int64_t)bh * t_k * D;

  load_tile<T, D>(sQ, q + qoff, q0, t_q);
  load_tile<T, D>(sO, dout + qoff, q0, t_q);

  float row_lse[4], row_dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < t_q ? lse[(int64_t)bh * t_q + row] : 0.f;
    row_dd[i] = row < t_q ? dd[(int64_t)bh * t_q + row] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_kt = (t_k + BT - 1) / BT;
  if (causal) n_kt = min(n_kt, (min(q0 + BT, t_q) - 1) / BT + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // previous iteration done with sK/sV/sS
    load_tile<T, D>(sK, k + koff, k0, t_k);
    load_tile<T, D>(sV, v + koff, k0, t_k);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    patch_abt<D>(s, sQ, sK, ty, tx);
    patch_abt<D>(dp, sO, sV, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= t_k || (causal && qpos < kpos)) x = NEG_INF;
        const float p = (x > NEG_INF * 0.5f && qpos < t_q)
                            ? expf(x - row_lse[i]) : 0.f;
        sS[(ty + 16 * i) * LDP + tx + 16 * j] =
            p * (dp[i][j] - row_dd[i]) * scale;
      }
    }
    __syncthreads();
    patch_pb<D>(acc, sS, sK, ty, tx);  // dq += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_q) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      from_f32(&dq[qoff + (int64_t)row * D + tx + 16 * j], acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k,
                     int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;              // [64][LD]
  float* sV = sK + BT * LD;      // [64][LD]
  float* sQ = sV + BT * LD;      // [64][LD]
  float* sO = sQ + BT * LD;      // dO tile [64][LD]
  float* sP = sO + BT * LD;      // P^T tile [k][q], [64][LDP]
  float* sS = sP + BT * LDP;     // dS^T tile [k][q], [64][LDP]
  float* sL = sS + BT * LDP;     // lse of the visited q tile [64]
  float* sD = sL + BT;           // D of the visited q tile [64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int tx = threadIdx.x & 15;   // q column of the score patch
  const int ty = threadIdx.x >> 4;   // k row of the score patch
  const int64_t qoff = (int64_t)bh * t_q * D;
  const int64_t koff = (int64_t)bh * t_k * D;

  load_tile<T, D>(sK, k + koff, k0, t_k);
  load_tile<T, D>(sV, v + koff, k0, t_k);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (t_q + BT - 1) / BT;
  // causal: q tile qt is live iff its last row qt*64+63 >= k0 (equal tiles)
  const int qt0 = causal ? k0 / BT : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // previous iteration done with sQ/sO/sP/sS/sL/sD
    load_tile<T, D>(sQ, q + qoff, q0, t_q);
    load_tile<T, D>(sO, dout + qoff, q0, t_q);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < t_q ? lse[(int64_t)bh * t_q + row] : 0.f;
      sD[threadIdx.x] = row < t_q ? dd[(int64_t)bh * t_q + row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T on this thread's patch: k rows ty+16i, q cols tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    patch_abt<D>(s, sK, sQ, ty, tx);
    patch_abt<D>(dp, sV, sO, ty, tx);

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const int qpos = q0 + qc;
      const float l = sL[qc], dq_row = sD[qc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
        float x = s[i][j] * scale;
        if (kpos >= t_k || (causal && qpos < kpos)) x = NEG_INF;
        const float p = (x > NEG_INF * 0.5f && qpos < t_q) ? expf(x - l) : 0.f;
        sP[(ty + 16 * i) * LDP + qc] = p;
        sS[(ty + 16 * i) * LDP + qc] = p * (dp[i][j] - dq_row) * scale;
      }
    }
    __syncthreads();
    patch_pb<D>(acc_v, sP, sO, ty, tx);  // dv += P^T dO
    patch_pb<D>(acc_k, sS, sQ, ty, tx);  // dk += dS^T Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t_k) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int64_t at = koff + (int64_t)row * D + tx + 16 * j;
      from_f32(&dk[at], acc_k[i][j]);
      from_f32(&dv[at], acc_v[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dd,
                      void* dq, int bh, int t_q, int t_k, int causal,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (size_t)(4 * BT * (D + 1) + BT * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t_q + BT - 1) / BT);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dq), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dd,
                       void* dk, void* dv, int bh, int t_q, int t_k,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * (size_t)(4 * BT * (D + 1) + 2 * BT * LDP + 2 * BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t_k + BT - 1) / BT);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_k, causal, scale);
  return cudaGetLastError();
}

bool bad_dims(int bh, int t_q, int t_k) {
  return bh <= 0 || t_q <= 0 || t_k <= 0 || (t_q + BT - 1) / BT > 65535 ||
         (t_k + BT - 1) / BT > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64 or 128.  q, k, v, dout, dq, dk,
// dv contiguous [bh, t, d]; lse and dd (= rowsum(dout * out)) f32
// [bh, t_q].  Each returns a cudaError_t; 0 is success.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* dd, void* dq, int bh, int t_q,
                                 int t_k, int d, int causal, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, t_q, t_k)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && d == 64)
    return (int)launch_dq<float, 64>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dq<float, 128>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 64)
    return (int)launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 128)
    return (int)launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* dd, void* dk, void* dv, int bh,
                                  int t_q, int t_k, int d, int causal,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_dims(bh, t_q, t_k)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && d == 64)
    return (int)launch_dkv<float, 64>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  if (dtype == 0 && d == 128)
    return (int)launch_dkv<float, 128>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 64)
    return (int)launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1 && d == 128)
    return (int)launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
