// LSTM forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_kernel` launched by `_run` in
// deeplearning4j_tpu/ops/pallas_lstm.py.  Given the hoisted input
// projection xz[t] = x_t·W + b ([T, B, 4H], time-major, gates IFOG), the
// recurrent weights U [H, 4H] and the initial state h0, c0 [B, H], it runs
//   z = xz[t] + h·U;  i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
//   c = f·c + i·g;     h = o·tanh(c)
// for t = 0 .. T-1 and writes ys [T, B, H], hT and cT [B, H], all f32.
//
// What bounds it.  Each step is a [B, H] x [H, 4H] product that depends on
// the step before: 2·B·4H·H operations for 4·B·H bytes of xz and B·H of
// ys, so at B = 128, H = 256 the whole sequence is bound by operations
// (67 TFLOP/s of f32 on the CUDA cores).  But the steps are serial: the
// product of step t cannot start before every h of step t-1 is written,
// so each step pays one device-wide barrier and one round trip of h
// through L2, whatever the card's peak.
//
// Design.  One cooperative launch runs the whole sequence; every CTA is
// resident at once (the wrapper sizes the grid from the occupancy of this
// kernel times the SM count, and cudaLaunchCooperativeKernel refuses a
// grid that would not be).  A CTA owns `hu` hidden units (all four gate
// columns of each) and `rows` batch rows:
// - U resident: the CTA's columns of U are staged once, at the start, into
//   dynamic shared memory as one float4 (i, f, o, g) per (k, unit):
//   16·H·hu bytes (64 KB at H = 256, hu = 16).  The TPU kernel keeps all
//   of U in VMEM; at H = 256 f32 U is 1 MiB, more than four SMs' shared
//   memory, so here it is split across the CTAs by unit.
// - State: each thread owns `RB` rows of one unit, so its c stays in
//   registers for the whole sequence.  h is exchanged through global
//   memory: ys[t-1] is h_{t-1}.  After the step's stores, one grid barrier
//   (cooperative_groups grid sync, which fences memory); the next step
//   reads ys[t-1] with ld.global.cg, from L2, never from a stale L1 line.
// - The product: per step the CTA stages its rows of h_{t-1} in chunks of
//   `kc` columns into shared memory (row stride kc + 1, so the row groups
//   of a warp fall in different banks), then each thread accumulates
//   z = xz + Σ_k h[r, k]·U[k, (i,f,o,g) of u] for its RB rows: one 16-byte
//   load of U and RB broadcast loads of h per k, 4·RB FMAs.
// - Arithmetic: f32 FMAs (no TF32, no tensor cores), expf and tanhf
//   (accurate, not the __expf intrinsic).  Rows and units past B and H are
//   computed on zeros and never stored, so any B >= 1 and H >= 1 work.
// Thread block clusters with distributed shared memory (U split across 8
// to 16 CTAs of a cluster, cluster.sync() in place of the grid barrier)
// and tensor cores are the kernel's next step.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int RB>
__global__ void __launch_bounds__(256)
lstm_fwd_kernel(const float* __restrict__ xz, const float* __restrict__ U,
                const float* h0, const float* __restrict__ c0, float* ys,
                float* __restrict__ hT, float* __restrict__ cT, int T, int B,
                int H, int hu, int kc_max) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* us = reinterpret_cast<float4*>(smem_raw);             // [H][hu]
  float* hs = reinterpret_cast<float*>(us + (size_t)H * hu);   // [rows][kc+1]

  const int tid = threadIdx.x;
  const int groups = blockDim.x / hu;       // row groups of RB rows
  const int rows = groups * RB;
  const int ks = kc_max + 1;
  const int unit_blocks = (H + hu - 1) / hu;
  const int u0 = (blockIdx.x % unit_blocks) * hu;
  const int r0 = (blockIdx.x / unit_blocks) * rows;
  const int u = tid % hu, rg = tid / hu;
  const int gu = u0 + u;
  const size_t h4 = 4 * (size_t)H;

  // U's columns of this CTA's units, gates side by side
  for (int e = tid; e < H * hu; e += blockDim.x) {
    const int k = e / hu, g = u0 + (e - k * hu);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < H) {
      const float* row = U + (size_t)k * h4 + g;
      w = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
    }
    us[e] = w;
  }

  bool ok[RB];
  int r[RB];
  float c[RB], h[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    r[j] = r0 + rg * RB + j;
    ok[j] = gu < H && r[j] < B;
    c[j] = ok[j] ? c0[(size_t)r[j] * H + gu] : 0.f;
    h[j] = 0.f;
  }

  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : ys + (size_t)(t - 1) * B * H;
    const float* xt = xz + (size_t)t * B * h4;
    float acc[RB][4];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float* p = xt + (size_t)r[j] * h4 + gu;
      acc[j][0] = ok[j] ? p[0] : 0.f;
      acc[j][1] = ok[j] ? p[H] : 0.f;
      acc[j][2] = ok[j] ? p[2 * H] : 0.f;
      acc[j][3] = ok[j] ? p[3 * H] : 0.f;
    }
    for (int k0 = 0; k0 < H; k0 += kc_max) {
      const int kc = min(kc_max, H - k0);
      __syncthreads();   // the previous chunk (or U's staging) is consumed
      for (int e = tid; e < rows * kc; e += blockDim.x) {
        const int rr = e / kc, kk = e - rr * kc, row = r0 + rr;
        hs[rr * ks + kk] = row < B ? __ldcg(hp + (size_t)row * H + k0 + kk)
                                   : 0.f;
      }
      __syncthreads();
      const float4* w = us + (size_t)k0 * hu + u;
      const float* hr = hs + rg * RB * ks;
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float4 wk = w[(size_t)kk * hu];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const float hv = hr[j * ks + kk];
          acc[j][0] = fmaf(hv, wk.x, acc[j][0]);
          acc[j][1] = fmaf(hv, wk.y, acc[j][1]);
          acc[j][2] = fmaf(hv, wk.z, acc[j][2]);
          acc[j][3] = fmaf(hv, wk.w, acc[j][3]);
        }
      }
    }
    float* yt = ys + (size_t)t * B * H;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float ig = sigmoid_f(acc[j][0]);
      const float fg = sigmoid_f(acc[j][1]);
      const float og = sigmoid_f(acc[j][2]);
      const float gg = tanhf(acc[j][3]);
      c[j] = fg * c[j] + ig * gg;
      h[j] = og * tanhf(c[j]);
      if (ok[j]) yt[(size_t)r[j] * H + gu] = h[j];
    }
    if (t + 1 < T) grid.sync();   // h_t written everywhere before step t+1
  }
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    if (ok[j]) {
      hT[(size_t)r[j] * H + gu] = h[j];
      cT[(size_t)r[j] * H + gu] = c[j];
    }
  }
}

const void* kernel_for(int rb) {
  switch (rb) {
    case 1: return (const void*)lstm_fwd_kernel<1>;
    case 2: return (const void*)lstm_fwd_kernel<2>;
    case 4: return (const void*)lstm_fwd_kernel<4>;
    default: return nullptr;
  }
}

size_t smem_bytes(int H, int hu, int rows, int kc) {
  return (size_t)H * hu * sizeof(float4) + (size_t)rows * (kc + 1) * sizeof(float);
}

}  // namespace

// What the planner needs of this card for one configuration: out[0] the
// CTAs of `threads` threads and `smem` bytes an SM holds at once (0 if the
// configuration cannot launch), out[1] the SM count, out[2] the shared
// memory one block may opt in to, out[3] whether cooperative launches are
// supported.  Returns a cudaError_t (0 on success).
extern "C" int lstm_fwd_occupancy(int rb, int threads, int smem, int* out) {
  const void* fn = kernel_for(rb);
  if (fn == nullptr || threads <= 0 || threads > 256 || smem < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[3], cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = 0;
  if (smem > out[2]) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, threads, smem);
  return (int)err;
}

// xz [T, B, 4H], U [H, 4H], h0 and c0 [B, H] in; ys [T, B, H], hT and cT
// [B, H] out; all f32 and contiguous.  The plan: rb rows per thread (1, 2
// or 4), hu units per CTA, `threads` threads per CTA (a multiple of hu),
// kc columns of h staged at a time.  One cooperative launch of
// ceil(H / hu) x ceil(B / rows) CTAs, rows = rb·threads/hu.  Returns a
// cudaError_t (0 on success).
extern "C" int lstm_fwd(const void* xz, const void* U, const void* h0,
                        const void* c0, void* ys, void* hT, void* cT, int T,
                        int B, int H, int rb, int hu, int threads, int kc,
                        void* stream) {
  const void* fn = kernel_for(rb);
  if (fn == nullptr || T < 1 || B < 1 || H < 1 || hu < 1 || threads < hu ||
      threads > 256 || threads % hu != 0 || kc < 1 || kc > H)
    return (int)cudaErrorInvalidValue;
  const int rows = rb * (threads / hu);
  const long long grid = (long long)((H + hu - 1) / hu) * ((B + rows - 1) / rows);
  const size_t smem = smem_bytes(H, hu, rows, kc);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* a_xz = static_cast<const float*>(xz);
  const float* a_u = static_cast<const float*>(U);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  float* a_ys = static_cast<float*>(ys);
  float* a_ht = static_cast<float*>(hT);
  float* a_ct = static_cast<float*>(cT);
  void* args[] = {&a_xz, &a_u, &a_h0, &a_c0, &a_ys, &a_ht, &a_ct,
                  &T, &B, &H, &hu, &kc};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(threads),
                                    args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
