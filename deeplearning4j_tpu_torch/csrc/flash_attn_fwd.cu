// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_kernel` launched by `_flash_fwd_call`
// in deeplearning4j_tpu/ops/flash_attention.py: causal or full
// online-softmax attention over [b*h, t, d], writing O (input dtype) and
// the per-row logsumexp (f32, [b*h, t]).  Fully masked rows give zeros
// and lse = NEG_INF; ragged t (not a multiple of the tile) is masked.
//
// Work split.  One CTA per (b*h, BQ-row q tile); the TPU kernel's
// sequential key-block grid axis becomes a loop inside the CTA.  Each
// warp owns 16 query rows (the FlashAttention-2 split) and carries their
// running max m, row sum l and O accumulator in mma fragments (f32).
// Under `causal` the loop stops at the CTA's diagonal tile (that is
// `_block_live`'s skip) and a warp skips the key tiles wholly above its
// own rows.  The grid is 1-D and issues the q tiles from the last (the
// longest key loop under `causal`) to the first, so the final wave holds
// the cheap tiles and not the diagonal ones.
//
// Arithmetic: tensor cores at f32 accuracy.  Both products run as
// mma.sync m16n8k8 TF32 with f32 accumulation.  One TF32 pass keeps 10
// mantissa bits of each operand, about three decimal digits; so each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (`cvt.rna`), and each product is taken as lo*hi +
// hi*lo + hi*hi, the small terms first (CUTLASS's 3xTF32,
// cutlass/gemm/warp/mma_tensor_op_fast_f32.h; CUTLASS rounds hi toward
// zero, which at the same cost leaves lo twice as large and the dropped
// lo*lo term four times as large).  The dropped term and lo's rounding
// are ~2^-22 of each product.  P (f32, in [0, 1]) is split the same way.
// The tensor cores do not round their f32 sums to nearest (they drop the
// low bits), so three mma per k-step straight into the running S or O
// accumulator bias it by up to three of its ulps per step: over 512 keys
// that put O 7e-6 from the plain f32 forward on the card, several times
// the old CUDA-core kernel's error and enough to move the TransformerLM's
// noise-only gradients past their gate.  So each k-step's three products
// go into a zeroed 16x8 tile, whose own magnitude is small, and that tile
// is added to the accumulator in f32 (round to nearest): 4 adds per 3
// mma.  bf16 inputs are exact in TF32, so their Q*K^T is one pass and
// their P*V two (P hi and lo against V), straight into the accumulators
// (their tolerance is a bf16 ulp).  `ops/flash_attention._tf32_split` is the same split in
// torch; the CPU tests run the plain tiled forward through it.
// Why mma.sync and not wgmma: wgmma takes TF32 only with both operands
// K-major, and V [key, d] is the MN-major B of P*V, so it would need a
// transposed copy of every V tile; mma.sync reads V as it lies.
//
// Fragments without shuffles.  In m16n8k8 TF32, lane (g = lane/4,
// t = lane%4) holds A at (g, t), (g+8, t), (g, t+4), (g+8, t+4), B at
// (k = t, n = g), (t+4, g), and C at (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).  The order of the 8 k values inside one mma is free as
// long as A and B agree, so k = t stands for element 2t and k = t+4 for
// 2t+1 of each group of 8.  Then
//  - Q*K^T: A = Q and B = K^T read (row, 2t..2t+1) as one 8-byte load;
//  - P*V: the C fragment of S for keys 8j..8j+7 IS the A fragment of P
//    for k-step j (no exchange between lanes), and B = V reads rows
//    8j+2t and 8j+2t+1 at column g.
// Shared-memory strides keep every fragment load free of bank conflicts:
// Q and K rows are D+8 floats (8-byte loads: lanes 8g+2t in each half
// warp), V rows D+4 (lanes 2t*(D+4)+g = 8t+g, and 8t+4+g).  Both keep
// 16-byte rows for cp.async.
//
// Asynchronous copies, operands split once.  K and V tiles are fetched
// with cp.async (16 bytes per thread, zero-filled past t_k by a source
// size of 0) into a staging buffer in the input type.  At the top of each
// iteration the CTA converts the staged tile once into the f32 tiles the
// fragments read: the TF32 hi and lo parts of f32 input, or bf16 widened;
// then the next tile's copy is issued into the staging buffer and lands
// while this one is multiplied.  Splitting each K and V element once per
// CTA, not once per warp that reads it, matters: the split's three ALU
// instructions per operand, taken in every warp, made an earlier version
// bound by instruction issue (on the card, dropping the splits saved far
// more time than dropping one of the three mma passes).
// Q is loaded once, widened and kept in shared memory (at d > 64 its
// fragments would not fit in registers beside the O accumulator); its
// A fragments are split as they are read, 4 values per k-step against
// the BK/8 B fragments they meet.
//
// What bounds it.  At the serving shape ([128, 512, 64], causal, f32) the
// work is 4.3 GFLOP, 0.026 ms at the card's 165 TFLOP/s of f32-accurate
// tensor work (495 TFLOP/s TF32 over three passes), against 0.020 ms to
// move q/k/v/o (67 MB): operations bound it.  In bf16 the bytes do.
//
// Tiles (BQ query rows, BK keys, threads = 2 * BQ) and shared memory
// (f32 / bf16), all inside the 227 KB a block may use:
//   d = 64:  BQ 128, BK 64   138 / 87 KB
//   d = 128: BQ 128, BK 32   167 / 117.5 KB
//   d = 192: BQ 64,  BK 32   197 / 123.5 KB
//   d = 256: BQ 64,  BK 16   163.5 / 115 KB
// One CTA per SM at f32; up to 8 warps with their accumulators in
// registers (up to 255 a thread).
#include "flash_common.cuh"

namespace {

template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 128, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 128, BK = 32; };
template <> struct Tiles<192> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tiles<256> { static constexpr int BQ = 64, BK = 16; };

// Shared-memory layout of one instance: Q (f32), then K and V as f32 hi
// parts and, for f32 inputs, lo parts, then the raw staging buffer of the
// next K and V tiles in the input type.
template <typename T, int D>
struct Layout {
  static constexpr bool BF16 = IsBf16<T>::value;
  static constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  static constexpr int NT = 2 * BQ;           // BQ / 16 warps
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = D + 4;
  static constexpr int PARTS = BF16 ? 1 : 2;  // hi (and lo) of K and V
  static constexpr int Q_FLOATS = BQ * LDQ;
  static constexpr int K_FLOATS = BK * LDK;
  static constexpr int V_FLOATS = BK * LDV;
  static constexpr size_t RAW_BYTES = 2 * BK * D * sizeof(T);
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(Q_FLOATS + PARTS * (K_FLOATS + V_FLOATS)) + RAW_BYTES;
};

template <typename T, int D>
__global__ void __launch_bounds__(Layout<T, D>::NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int bh, int t_q, int t_k, int causal,
                 float scale) {
  using L = Layout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT;
  constexpr int LDQ = L::LDQ, LDK = L::LDK, LDV = L::LDV;
  constexpr bool SPLIT = !L::BF16;   // Q, K, V need a lo term (f32 only)
  constexpr int NS = BK / 8;         // n-tiles of S per warp
  constexpr int NO = D / 8;          // n-tiles of O per warp
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                               // [BQ][LDQ]
  float* sKh = sQ + L::Q_FLOATS;                  // [BK][LDK]
  float* sKl = sKh + (SPLIT ? L::K_FLOATS : 0);   // f32 only
  float* sVh = sKl + L::K_FLOATS;                 // [BK][LDV]
  float* sVl = sVh + (SPLIT ? L::V_FLOATS : 0);   // f32 only
  T* rawK = reinterpret_cast<T*>(sVl + L::V_FLOATS);   // [BK][D] each
  T* rawV = rawK + BK * D;

  // heaviest q tiles first: block i -> (q tile n_qt-1-i/bh, head i%bh)
  const int n_qt = (t_q + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
  const int head = (int)(blockIdx.x % bh);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;               // the warp's first row in the tile
  const int64_t qoff = (int64_t)head * t_q * D;
  const int64_t koff = (int64_t)head * t_k * D;

  int n_kt = (t_k + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, t_q) - 1) / BK + 1);

  // tile 0 in flight while Q is staged
  issue_raw<T, BK, D, NT>(rawK, k + koff, 0, t_k);
  issue_raw<T, BK, D, NT>(rawV, v + koff, 0, t_k);
  cp_async_commit();
  load_rows_f32<T, BQ, D, LDQ, NT>(sQ, q + qoff, q0, t_q);

  const float c = scale * LOG2E;    // scores in log2 units
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int row_a = q0 + wrow + g;          // this lane's two rows
  const int row_b = row_a + 8;
  const bool warp_live = q0 + wrow < t_q;
  const float* qa = sQ + (wrow + g) * LDQ + 2 * t4;
  const float* qb = qa + 8 * LDQ;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    cp_async_wait_all();
    __syncthreads();            // tile j staged; iteration j-1 is done
    convert_tile<BK, D, LDK, NT>(sKh, sKl, rawK);
    convert_tile<BK, D, LDV, NT>(sVh, sVl, rawV);
    __syncthreads();            // tiles ready; staging free
    if (j + 1 < n_kt) {         // tile j+1 lands while tile j is multiplied
      issue_raw<T, BK, D, NT>(rawK, k + koff, k0 + BK, t_k);
      issue_raw<T, BK, D, NT>(rawV, v + koff, k0 + BK, t_k);
    }
    cp_async_commit();
    // warp-uniform: nothing of this tile reaches the warp's rows
    if (!warp_live || (causal && k0 > q0 + wrow + 15)) continue;

    // ---- S = Q K^T (16 x BK per warp) ----
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4];
      load_a<SPLIT>(qa + kk, qb + kk, ah, al);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int at = (n * 8 + g) * LDK + kk + 2 * t4;
        const uint2 bh = *reinterpret_cast<const uint2*>(sKh + at);
        if constexpr (SPLIT) {
          const uint2 bl = *reinterpret_cast<const uint2*>(sKl + at);
          mma3(s[n], ah, al, bh.x, bh.y, bl.x, bl.y);
        } else {
          mma_tf32(s[n], ah, bh.x, bh.y);
        }
      }
    }

    // ---- online softmax on the fragments: rows g (r=0) and g+8 (r=1) ----
    const bool edge = k0 + BK > t_k || (causal && k0 + BK - 1 > q0 + wrow);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * r + e] * c;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t4 + e;
            if (kpos >= t_k || (causal && row < kpos)) x = NEG_INF;
          }
          s[n][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      // the 4 lanes of a quad share the row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * r + e];
          const float p = x > NEG_INF * 0.5f ? exp2f(x - m_new) : 0.f;
          s[n][2 * r + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // ---- O += P V: S's C fragment of keys 8j..8j+7 is P's A fragment ----
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      uint32_t ph[4], pl[4];
      c_to_a(s[jj], ph, pl);
      const int v0 = (jj * 8 + 2 * t4) * LDV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint32_t vh0 = __float_as_uint(sVh[v0 + n * 8]);
        const uint32_t vh1 = __float_as_uint(sVh[v0 + LDV + n * 8]);
        if constexpr (SPLIT) {
          const uint32_t vl0 = __float_as_uint(sVl[v0 + n * 8]);
          const uint32_t vl1 = __float_as_uint(sVl[v0 + LDV + n * 8]);
          mma3(acc[n], ph, pl, vh0, vh1, vl0, vl1);
        } else {
          mma_tf32(acc[n], pl, vh0, vh1);
          mma_tf32(acc[n], ph, vh0, vh1);
        }
      }
    }
  }

  T* ob = o + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= t_q) continue;
    const float li = l[r] == 0.f ? 1.f : l[r];   // fully masked row -> zeros
    const float inv = 1.f / li;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(ob + (int64_t)row * D + n * 8 + 2 * t4, acc[n][2 * r] * inv,
             acc[n][2 * r + 1] * inv);
    if (t4 == 0)
      lse[(int64_t)head * t_q + row] = l[r] == 0.f ? NEG_INF : m[r] * LN2 + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int t_q, int t_k, int causal,
                   float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * ((t_q + L::BQ - 1) / L::BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, L::NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, bh, t_q, t_k, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int t_q, int t_k, int causal, float scale,
             cudaStream_t s) {
  switch (d) {
    case 64: return (int)launch<T, 64>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
    case 128: return (int)launch<T, 128>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
    case 192: return (int)launch<T, 192>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
    case 256: return (int)launch<T, 256>(q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64, 128, 192 or 256.  All tensors
// contiguous [bh, t, d] and 16-byte aligned (lse [bh, t_q]).  Returns a
// cudaError_t; 0 is success.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int t_q, int t_k,
                              int d, int causal, float scale, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t_q <= 0 || t_k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
