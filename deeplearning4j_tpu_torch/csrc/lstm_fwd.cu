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
// ys, so at B = 128, H = 256 the whole sequence is bound by operations.
// But the steps are serial: the product of step t cannot start before
// every h of step t-1 is known to the threads that need it, so each step
// pays one exchange of h and a wait for it, whatever the card's peak.  The
// latency of the step's chain (product, cell, exchange), not arithmetic
// throughput, sets the pace at the char-LSTM's shape.
//
// Two tiers, chosen by the host planner (ops/pallas_lstm.py) from the
// shape before the launch; neither gives way to the other at run time.
//
// Cluster tier (lstm_fwd_cluster_kernel<R>, lstm_fwd_cluster): batch rows
// are independent, so only the CTAs that share a row's hidden units have
// to exchange h at each step.  A thread-block cluster of `cl` CTAs owns R
// batch rows and all H units; clusters never synchronise with each other, so
// the launch is an ordinary one (cudaLaunchKernelEx with a cluster
// dimension) and a grid wider than the card runs in waves.
// - U resident: CTA `rank` owns units [rank·hu, rank·hu + hu), hu =
//   ceil(H / cl), and keeps their four gate columns in shared memory as
//   one float4 (i, f, o, g) per (k, unit) for the whole sequence:
//   16·H·hu bytes (128 KB at H = 256, cl = 8).
// - h through distributed shared memory: every CTA holds h_{t-1} of its
//   cluster's R rows, all H columns, in a double buffer [2][R][H], and one
//   mbarrier per buffer.  After the cell of step t each thread stores its
//   h_t into the other buffer of every CTA of the cluster with st.async,
//   which counts the 4 bytes off that CTA's mbarrier; a CTA starts step
//   t+1 when its mbarrier has counted all R·H·4 bytes of h_t.  There is no
//   barrier and no memory fence on the step's path: a cluster barrier's
//   arrive.release compiles to MEMBAR.ALL.GPU, a fence at device scope
//   that cost a first version more than the step's cell.  The double
//   buffer is safe without a barrier: a CTA sends h_{t+1} into the buffer
//   that held h_{t-1} only after it has received h_t from every CTA, and
//   each CTA sends h_t only after its product of step t, the last read of
//   h_{t-1}.
//   The last step sends nothing, and a CTA's last wait covers every byte
//   sent to it, so no CTA leaves while a peer still stores into it.  A
//   cluster barrier after the buffers and mbarriers are initialised makes
//   sure every CTA of the cluster runs before the first send.  ys, hT and
//   cT go to global memory as outputs only; they are never read back.
// - The product, split over k: thread (group g, unit u) sums
//   Σ_k h[r, k]·U[k, (i,f,o,g) of u] over its kc columns for all R rows
//   (R·4 accumulators): per 4 columns, 4 float4 loads of U, each serving
//   all R rows, and R float4 broadcast loads of h, each serving all four
//   gates.  The groups' partial sums go through shared memory
//   (one float4 per row and thread); the thread that owns (row, unit)
//   adds them to xz in group order, its loads in flight together.  Each
//   thread owns at most two (row, unit) cells, whose c stays in registers;
//   the next step's xz is loaded into registers while h_t travels.
// - One CTA per SM: each CTA asks for at least 116 KB of shared memory.
//   Where two fit an SM, the card may place a cluster's CTAs two to an
//   SM, which then computes two CTAs' steps one after the other.
// - Arithmetic: f32 FMAs in a fixed order (no TF32, no tensor cores, no
//   atomics: two launches give the same bits), expf and tanhf (accurate,
//   not the __expf intrinsic).  Each z takes at most kc + groups + 1
//   roundings, no more than the plain version's H + 1.
// It fits where U's columns, the h buffers and the partial sums fit one
// CTA's shared memory at cl <= 16 (16 is a non-portable cluster size):
// H up to about 470 on an H100.
//
// Grid tier (lstm_fwd_kernel<RB>, lstm_fwd), for the wider H: one
// cooperative launch runs the whole sequence; every CTA is resident at
// once (the wrapper sizes the grid from the occupancy of this kernel
// times the SM count, and cudaLaunchCooperativeKernel refuses a grid that
// would not be).  A CTA owns `hu` hidden units (all four gate columns of
// each) and `rows` batch rows:
// - U resident: the CTA's columns of U are staged once, at the start, into
//   dynamic shared memory as one float4 (i, f, o, g) per (k, unit):
//   16·H·hu bytes.  The TPU kernel keeps all of U in VMEM; at H = 1024 f32
//   U is 16 MiB, so here it is split across the CTAs by unit.
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
// - Arithmetic as in the cluster tier.
//
// In both tiers rows and units past B and H are computed on zeros and
// never stored, so any B >= 1 and H >= 1 work.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// ------------------------------------------------------------------- grid tier

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

// ---------------------------------------------------------------- cluster tier

// PTX for the cluster tier: the cluster barrier, shared-memory mbarriers
// and st.async, which stores into a peer CTA's shared memory and counts
// the bytes off that CTA's mbarrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Every thread of every CTA of the cluster arrives and waits.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the initialised mbarriers visible to the cluster's st.async.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This phase of `bar` completes when `bytes` more have arrived.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `bar` of this parity to complete; the bytes that
// completed it (st.async from any CTA of the cluster) are then visible.
// A phase that never completes is a fault of the kernel: trap rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                 "p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spin == (1LL << 24)) __trap();
  }
}

// v into the float at `p` (an address in this CTA's shared memory) of CTA
// `rank` of the cluster, counted off that CTA's copy of `bar`.
__device__ __forceinline__ void st_async(float* p, uint64_t* bar, int rank,
                                         float v) {
  uint32_t a = smem_addr(p), m = smem_addr(bar);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %2;\n"
               "mapa.shared::cluster.u32 %1, %1, %2;\n"
               : "+r"(a), "+r"(m) : "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
               "[%0], %1, [%2];\n"
               :: "r"(a), "r"(__float_as_uint(v)), "r"(m) : "memory");
}

// The (row, unit) cells a thread owns: tid and tid + blockDim.x.
constexpr int kCells = 2;

constexpr int kClusterThreads = 384;        // the most a CTA has

template <int R>
__global__ void __launch_bounds__(kClusterThreads)
lstm_fwd_cluster_kernel(const float* __restrict__ xz,
                        const float* __restrict__ U,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, float* __restrict__ ys,
                        float* __restrict__ hT, float* __restrict__ cT, int T,
                        int B, int H, int cl, int hu, int kc) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = (H + 3) & ~3;                // h row stride, float4-aligned
  const int nt = blockDim.x;                  // groups·hu
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);        // [2]
  float4* us = reinterpret_cast<float4*>(smem_raw + 16);         // [hp][hu]
  float* hbuf = reinterpret_cast<float*>(us + (size_t)hp * hu);  // [2][R][hp]
  float4* red = reinterpret_cast<float4*>(hbuf + 2 * R * hp);    // [R][nt]

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int u0 = rank * hu;
  const int r0 = (int)(blockIdx.x / cl) * R;
  const size_t h4 = 4 * (size_t)H;
  const int ng = (hp + kc - 1) / kc;          // groups that hold columns
  // bytes of h one step brings each CTA: the cluster's rows, all H units
  const uint32_t step_bytes = 4u * (uint32_t)min(R, B - r0) * (uint32_t)H;

  // U's columns of this CTA's units, gates side by side; zero past H.  A
  // gather from L2 or memory: unrolled so that each thread keeps several
  // in flight (for a short sequence this is most of the launch).
#pragma unroll 4
  for (int e = tid; e < hp * hu; e += nt) {
    const int k = e / hu, g = u0 + (e - k * hu);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < H && g < H) {
      const float* row = U + (size_t)k * h4 + g;
      w = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
    }
    us[e] = w;
  }
  // buffer 0 holds h_{-1} = h0 of the cluster's rows, buffer 1 zeros; the
  // columns and rows past H and B stay zero for the whole sequence
  for (int e = tid; e < 2 * R * hp; e += nt) {
    const int r = (e / hp) % R, k = e % hp, row = r0 + r;
    hbuf[e] = (e < R * hp && row < B && k < H) ? h0[(size_t)row * H + k]
                                               : 0.f;
  }
  // bars[b] counts the bytes of h arriving in buffer b: h_t goes to buffer
  // (t + 1) & 1, and only steps t < T-1 send.  One arrival a phase, this
  // CTA's thread 0 declaring the bytes; the sends may come before it.
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
    if (T >= 2) mbar_expect(&bars[1], step_bytes);   // h_0
    if (T >= 3) mbar_expect(&bars[0], step_bytes);   // h_1
  }

  // the cells this thread owns
  bool live[kCells], ok[kCells];
  int cr[kCells], cu[kCells];
  float c[kCells], h[kCells], xv[kCells][4];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int p = tid + j * nt;
    live[j] = p < R * hu;
    cr[j] = live[j] ? p / hu : 0;
    cu[j] = p - cr[j] * hu;
    ok[j] = live[j] && r0 + cr[j] < B && u0 + cu[j] < H;
    const size_t at = (size_t)(r0 + cr[j]) * H + u0 + cu[j];
    c[j] = ok[j] ? c0[at] : 0.f;
    h[j] = 0.f;
    const float* p0 = xz + (size_t)(r0 + cr[j]) * h4 + u0 + cu[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) xv[j][q] = ok[j] ? p0[(size_t)q * H] : 0.f;
  }

  // the product's share of this thread: unit u, columns [kb, ke)
  const int g = tid / hu, u = tid - g * hu;
  const int kb = min(g * kc, hp), ke = min(kb + kc, hp);

  // every CTA of the cluster runs, with its buffers and mbarriers
  // initialised, before any peer sends into them
  cluster_sync_all();

  for (int t = 0; t < T; ++t) {
    const int b = t & 1;                      // h_{t-1} lives in buffer b
    if (t > 0) {
      // h_{t-1}: phase (t-1)/2 of bars[b]
      mbar_wait(&bars[b], (uint32_t)((t - 1) >> 1) & 1u);
      if (tid == 0 && t + 2 < T) mbar_expect(&bars[b], step_bytes);  // h_{t+1}
    }
    const float* hcur = hbuf + b * R * hp;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4   // later columns' loads overlap these FMAs
    for (int k = kb; k < ke; k += 4) {
      const float4* w = us + (size_t)k * hu + u;
      const float4 w0 = w[0], w1 = w[hu], w2 = w[2 * hu], w3 = w[3 * hu];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hcur + r * hp + k);
        acc[r][0] = fmaf(hv.x, w0.x, acc[r][0]);
        acc[r][1] = fmaf(hv.x, w0.y, acc[r][1]);
        acc[r][2] = fmaf(hv.x, w0.z, acc[r][2]);
        acc[r][3] = fmaf(hv.x, w0.w, acc[r][3]);
        acc[r][0] = fmaf(hv.y, w1.x, acc[r][0]);
        acc[r][1] = fmaf(hv.y, w1.y, acc[r][1]);
        acc[r][2] = fmaf(hv.y, w1.z, acc[r][2]);
        acc[r][3] = fmaf(hv.y, w1.w, acc[r][3]);
        acc[r][0] = fmaf(hv.z, w2.x, acc[r][0]);
        acc[r][1] = fmaf(hv.z, w2.y, acc[r][1]);
        acc[r][2] = fmaf(hv.z, w2.z, acc[r][2]);
        acc[r][3] = fmaf(hv.z, w2.w, acc[r][3]);
        acc[r][0] = fmaf(hv.w, w3.x, acc[r][0]);
        acc[r][1] = fmaf(hv.w, w3.y, acc[r][1]);
        acc[r][2] = fmaf(hv.w, w3.z, acc[r][2]);
        acc[r][3] = fmaf(hv.w, w3.w, acc[r][3]);
      }
    }
    __syncthreads();      // every cell of step t-1 has read the partials
#pragma unroll
    for (int r = 0; r < R; ++r)
      red[(size_t)r * nt + tid] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();

    const bool more = t + 1 < T;
    float* hnext = hbuf + (b ^ 1) * R * hp;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (!live[j]) continue;
      float z[4] = {xv[j][0], xv[j][1], xv[j][2], xv[j][3]};
      const float4* rp = red + (size_t)cr[j] * nt + cu[j];
#pragma unroll 8
      for (int gg = 0; gg < ng; ++gg) {     // loads in flight together
        const float4 v = rp[gg * hu];
        z[0] += v.x;
        z[1] += v.y;
        z[2] += v.z;
        z[3] += v.w;
      }
      const float ig = sigmoid_f(z[0]);
      const float fg = sigmoid_f(z[1]);
      const float og = sigmoid_f(z[2]);
      const float gv = tanhf(z[3]);
      c[j] = fg * c[j] + ig * gv;
      h[j] = og * tanhf(c[j]);
      if (ok[j] && more) {
        float* dst = hnext + cr[j] * hp + u0 + cu[j];
        for (int q = 0; q < cl; ++q) st_async(dst, &bars[b ^ 1], q, h[j]);
      }
    }
    // outputs and the next step's xz while h_t travels
    float* yt = ys + (size_t)t * B * H;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (!ok[j]) continue;
      yt[(size_t)(r0 + cr[j]) * H + u0 + cu[j]] = h[j];
      if (more) {
        const float* p0 = xz + ((size_t)(t + 1) * B + r0 + cr[j]) * h4 + u0 + cu[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[j][q] = p0[(size_t)q * H];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    if (ok[j]) {
      const size_t at = (size_t)(r0 + cr[j]) * H + u0 + cu[j];
      hT[at] = h[j];
      cT[at] = c[j];
    }
  }
}

// Instances for 1 to 16 rows a cluster: the planner picks the rows that
// spread the batch over the clusters the card runs at once.
template <int R>
const void* cluster_kernel_upto(int rows) {
  if constexpr (R == 0) {
    return nullptr;
  } else {
    return rows == R ? (const void*)lstm_fwd_cluster_kernel<R>
                     : cluster_kernel_upto<R - 1>(rows);
  }
}

const void* cluster_kernel_for(int rows) { return cluster_kernel_upto<16>(rows); }

// Shared memory a cluster-tier CTA asks for: what it uses, and at least
// kOneCtaPerSm, more than half an SM's 228 KB, so one SM holds one CTA.
constexpr size_t kOneCtaPerSm = 116 * 1024;

size_t cluster_smem_bytes(int H, int hu, int rows, int threads) {
  const size_t hp = (size_t)((H + 3) & ~3);
  const size_t used = 16 + hp * hu * sizeof(float4) +
                      2 * (size_t)rows * hp * sizeof(float) +
                      (size_t)rows * 4 * threads * sizeof(float);
  return used > kOneCtaPerSm ? used : kOneCtaPerSm;
}

// The most dynamic shared memory a kernel may ask for, and for 16-CTA
// clusters leave to exceed the portable cluster size of 8.
cudaError_t set_attributes(const void* fn, int smem, bool nonportable) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && nonportable)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
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
  err = set_attributes(fn, smem, false);
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
  cudaError_t err = set_attributes(fn, (int)smem, false);
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

namespace {

cudaLaunchConfig_t cluster_config(unsigned grid, int threads, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int cl) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// What the planner needs of this card for one cluster-tier configuration
// (`rows` rows per cluster, `cl` CTAs of `threads` threads and `smem`
// bytes): out[0] the clusters the card runs at once (0 if it cannot run
// one: too much shared memory, or a cluster size the card refuses for
// it), out[1] whether the card launches clusters at all, out[2] the
// shared memory one block may opt in to.  Returns a cudaError_t (0 on
// success).
extern "C" int lstm_fwd_cluster_occupancy(int rows, int cl, int threads,
                                          int smem, int* out) {
  const void* fn = cluster_kernel_for(rows);
  if (fn == nullptr || cl < 1 || cl > 16 || threads <= 0 ||
      threads > kClusterThreads || smem < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrClusterLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[2], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = 0;
  if (!out[1] || smem > out[2]) return 0;
  err = set_attributes(fn, smem, cl > 8);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config((unsigned)cl, threads, (size_t)smem, nullptr, &attr, cl);
  err = cudaOccupancyMaxActiveClusters(&out[0], fn, &cfg);
  if (err == cudaErrorInvalidClusterSize) {   // this size cannot run here
    cudaGetLastError();
    out[0] = 0;
    return 0;
  }
  return (int)err;
}

// The cluster tier.  Tensors as for lstm_fwd below.  The plan: `rows`
// batch rows per cluster (1 to 16), clusters of `cl` CTAs (at most 16),
// hu = ceil(H / cl) units per CTA, `threads` = groups·hu threads per CTA
// (at most 384) that split the k columns of the product into groups of
// kc (a multiple of 4, groups·kc >= H rounded up to 4), and at most two
// (row, unit) cells a thread (rows·hu <= 2·threads).  One launch of
// ceil(B / rows) clusters.  Returns a cudaError_t (0 on success).
extern "C" int lstm_fwd_cluster(const void* xz, const void* U, const void* h0,
                                const void* c0, void* ys, void* hT, void* cT,
                                int T, int B, int H, int rows, int cl, int hu,
                                int threads, int kc, void* stream) {
  const void* fn = cluster_kernel_for(rows);
  const int hp = (H + 3) & ~3;
  if (fn == nullptr || T < 1 || B < 1 || H < 1 || cl < 1 || cl > 16 ||
      hu < 1 || (long long)hu * cl < H || threads < hu ||
      threads > kClusterThreads || threads % hu != 0 || kc < 4 ||
      kc % 4 != 0 || (long long)(threads / hu) * kc < hp ||
      rows * hu > 2 * threads)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)((B + rows - 1) / rows) * cl;
  const size_t smem = cluster_smem_bytes(H, hu, rows, threads);
  cudaError_t err = set_attributes(fn, (int)smem, cl > 8);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config((unsigned)grid, threads, smem,
                     static_cast<cudaStream_t>(stream), &attr, cl);
  const float* a_xz = static_cast<const float*>(xz);
  const float* a_u = static_cast<const float*>(U);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  float* a_ys = static_cast<float*>(ys);
  float* a_ht = static_cast<float*>(hT);
  float* a_ct = static_cast<float*>(cT);
  void* args[] = {&a_xz, &a_u, &a_h0, &a_c0, &a_ys, &a_ht, &a_ct,
                  &T, &B, &H, &cl, &hu, &kc};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
