// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas kernels that `_flash_bwd` launches in
// deeplearning4j_tpu/ops/flash_attention.py:
//   `_flash_bwd_dq_kernel`  -> flash_bwd_dq_kernel  (dq)
//   `_flash_bwd_dkv_kernel` -> flash_bwd_dkv_kernel (dk, dv)
// Both replay the softmax block from the forward's logsumexp, as
// `_replay_p_ds` does:
//   S  = scale * Q K^T, causal positions above the diagonal masked
//   P  = exp(S - lse) where unmasked, else 0
//   dP = dO V^T
//   dS = P * (dP - D) * scale,      D = rowsum(dO * O), computed outside
// and accumulate dq = dS K, dk = dS^T Q, dv = P^T dO in f32.
//
// Work split.  The TPU kernels carry their accumulators in VMEM scratch
// across a sequential grid axis.  CUDA blocks run in no order, so each
// CTA owns one output tile and walks the other axis in a loop, and no CTA
// writes another's output: no atomics, and the results are the same bits
// from run to run.
//   dq:  a CTA owns BQ query rows, each warp 16 of them (the
//        FlashAttention-2 split), and loops over the key tiles up to the
//        causal diagonal.  The 1-D grid issues the last q tiles (the
//        longest loops under `causal`) first.
//   dkv: a CTA owns BK keys, each warp 16, and loops over the query tiles
//        from the diagonal to the end, reading lse and D of the visited
//        tile.  The grid issues the first k tiles (the longest loops)
//        first.  At d >= 192 a CTA computes dv or dk, not both (two CTAs
//        per key tile): two 16 x d f32 accumulators are d registers a
//        lane, more than the 255 a thread may have at d = 256.  The dv
//        CTA skips dP; the pair costs 10 d operations per live (q, k)
//        pair instead of 8 d.
// Under `causal` a warp skips the tiles wholly masked for its 16 rows.
//
// Arithmetic: the five products on the tensor cores at f32 accuracy, as
// in flash_attn_fwd.cu.  Each f32 operand is split into hi = tf32(x) and
// lo = tf32(x - hi) (`split_tf32`, both `cvt.rna`) and each product taken
// as lo*hi + hi*lo + hi*hi on mma.sync m16n8k8.  Each k-step's three
// products go into a zeroed 16x8 tile that is then added to the
// accumulator in f32: the tensor cores truncate their own sums, and three
// mma straight into a running accumulator bias it by up to three of its
// ulps per step.  That matters more here than in the forward: the
// TransformerLM's key-bias gradient is sum_j dk_j = sum_i q_i sum_j dS_ij,
// zero in exact arithmetic (sum_j dS_ij = scale (D_i - D_i)), so it is
// pure rounding noise and this kernel is where the noise is made.  bf16
// inputs are exact in TF32: Q K^T and dO V^T take one pass, and the
// products with the f32 P or dS operand two (P's hi and lo against the
// exact B), straight into the accumulators (their tolerance is a bf16
// ulp).  `ops/flash_attention.flash_attention_bwd_plain(matmul=...)` runs
// the same products in torch for the CPU tests.
//
// Fragments without shuffles (fragment layout in flash_common.cuh).  The
// order of the 8 k values inside one mma is free as long as A and B
// agree, so k = t stands for element 2t and k = t+4 for 2t+1: then the C
// fragment of S or dP for 8 columns IS the A fragment of the next
// product's k-step over those columns.  dq: S = Q K^T and dP = dO V^T
// (A = Q, dO rows as 8-byte pairs along d), dS on the C fragments, then
// dq += dS K with B = K read down its columns, one word at rows 2t and
// 2t+1 of the k-step.  dkv: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
// on the fragments (lse and D of the query columns from shared memory),
// then dv += P^T dO and dk += dS^T Q, B = dO and Q down their columns.
// So K (dq), and Q and dO (dkv) are each read both ways, 8-byte pairs
// along d and single words down a column, from one copy: with row stride
// D+8 (8 mod 32 words) the pairs of 16 lanes at rows g = 0..3 fall in
// distinct banks, but single words at rows 2t of a group of 8 do not
// (rows 0 and 2 share a bank).  The rows of each group of 8 are therefore
// taken in the order perm8(n) = n ^ ((n >> 2) & 1) = 0 1 2 3 5 4 7 6:
// column n of an S tile is row perm8(n) of K (resp. Q, dO), and then
// both the pair loads (rows perm8(g)) and the word loads (rows
// perm8(2t), perm8(2t+1)) are free of bank conflicts.
//
// Asynchronous copies, operands split once.  The tiles the loop walks (K
// and V in dq, Q and dO in dkv) are fetched with cp.async (16 bytes a
// thread, zero-filled past t) into a staging buffer in the input type one
// tile ahead, and converted once per CTA into the f32 hi and lo tiles the
// fragments read.  The CTA's own rows (Q and dO in dq, K and V in dkv)
// are loaded once, widened to f32 and split as they are read: each warp
// reads only its own 16 rows, 4 values per k-step against the NS B
// fragments they meet.
//
// What bounds it.  Per live (q, k) pair dq does 6 d operations (S, dP,
// dS K) and dkv 8 d (S, dP, P^T dO, dS^T Q).  At the training shape
// ([128, 512, 64], causal, f32) that is 6.45 and 8.6 GFLOP, 0.039 and
// 0.052 ms at the card's 165 TFLOP/s of f32-accurate tensor work (495
// TFLOP/s TF32 over three passes), against 0.03 ms to move the bytes:
// operations bound both.  Beside the mma the kernels issue the splits,
// the add of each zeroed tile (4 adds per 3 mma), the shared-memory loads
// of the B fragments (16 bytes a lane per three mma) and the elementwise
// softmax replay.  With one CTA of 255-register threads per SM (two warps
// a scheduler) the likeliest limit is the latency of each k-step's three
// dependent mma, a hypothesis no profiler has checked.  The tiles below
// were chosen by timing variants on the card; the k-step loops are not
// unrolled (unrolled by 2 they spilled more and ran 3-4 % slower at
// d = 64 on an H100).
//
// Tiles (rows a CTA owns x rows of a loop tile, threads = 32 per 16 owned
// rows), shared memory and registers a thread (f32 / bf16; ptxas for
// sm_90a), inside the 227 KB a block may use; one CTA per SM:
//   dq   d = 64:  BQ 128, BK 64   176 / 124 KB     254 / 155
//        d = 128: BQ 128, BK 16   186 / 161 KB     230 / 141
//        d = 192: BQ 64,  BK 16   174 / 137 KB     255 / 200
//        d = 256: BQ 64,  BK 8    181 / 156.5 KB   254 / 222
//   dkv  d = 64:  BK 128, BQ 32   124.2 / 98.2 KB  255 (32 B stack) / 152
//        d = 128: BK 128, BQ 16   186.1 / 161.1 KB 255 (96 B stack) / 220
//        d = 192: BK 64,  BQ 16   174.1 / 137.1 KB 255 (32 B stack) / 200
//                                                  (dv or dk a CTA)
//        d = 256: BK 64,  BQ 8    181.1 / 156.6 KB 255 / 231 (dv or dk a CTA)
#include "flash_common.cuh"

namespace {

template <int D> struct DqTiles;
template <> struct DqTiles<64> { static constexpr int BQ = 128, BK = 64; };
template <> struct DqTiles<128> { static constexpr int BQ = 128, BK = 16; };
template <> struct DqTiles<192> { static constexpr int BQ = 64, BK = 16; };
template <> struct DqTiles<256> { static constexpr int BQ = 64, BK = 8; };

// SPLIT_OUT: a CTA computes dv or dk, not both
template <int D> struct DkvTiles;
template <> struct DkvTiles<64> {
  static constexpr int BK = 128, BQ = 32; static constexpr bool SPLIT_OUT = false; };
template <> struct DkvTiles<128> {
  static constexpr int BK = 128, BQ = 16; static constexpr bool SPLIT_OUT = false; };
template <> struct DkvTiles<192> {
  static constexpr int BK = 64, BQ = 16; static constexpr bool SPLIT_OUT = true; };
template <> struct DkvTiles<256> {
  static constexpr int BK = 64, BQ = 8; static constexpr bool SPLIT_OUT = true; };

// Shared memory of dq: Q and dO (f32), K and V as f32 hi and (f32 input)
// lo parts, then the staging buffer of the next K and V tiles.
template <typename T, int D>
struct DqLayout {
  static constexpr bool BF16 = IsBf16<T>::value;
  static constexpr int BQ = DqTiles<D>::BQ, BK = DqTiles<D>::BK;
  static constexpr int NT = 2 * BQ;            // BQ / 16 warps
  static constexpr int LD = D + 8;
  static constexpr int PARTS = BF16 ? 1 : 2;
  static constexpr int Q_FLOATS = BQ * LD, K_FLOATS = BK * LD;
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(2 * Q_FLOATS + 2 * PARTS * K_FLOATS) +
      2 * (size_t)BK * D * sizeof(T);
};

// Shared memory of dkv: K and V (f32), Q and dO as hi and lo parts, lse
// (log2 units) and D of the visited q tile, then the staging buffer.
template <typename T, int D>
struct DkvLayout {
  static constexpr bool BF16 = IsBf16<T>::value;
  static constexpr int BK = DkvTiles<D>::BK, BQ = DkvTiles<D>::BQ;
  static constexpr bool SPLIT_OUT = DkvTiles<D>::SPLIT_OUT;
  static constexpr int NPART = SPLIT_OUT ? 2 : 1;   // CTAs per key tile
  static constexpr int NT = 2 * BK;                  // BK / 16 warps
  static constexpr int LD = D + 8;
  static constexpr int PARTS = BF16 ? 1 : 2;
  static constexpr int K_FLOATS = BK * LD, Q_FLOATS = BQ * LD;
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(2 * K_FLOATS + 2 * PARTS * Q_FLOATS + 2 * BQ) +
      2 * (size_t)BQ * D * sizeof(T);
};

// Row of a group of 8 that stands for column n of a product tile.
__device__ __forceinline__ int perm8(int n) { return n ^ ((n >> 2) & 1); }

// acc[n] += A * B[:, 8n..8n+7] over one k-step of 8 rows of B (row
// stride LD): B read down its columns, one word at each of rows r0 and r1
// (the rows standing for k = t and k = t+4), column 8n + g.
template <bool SPLIT, int NO, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[NO][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* bh,
                                         const float* bl, int r0, int r1, int g) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + g;
    const uint32_t h0 = __float_as_uint(bh[r0 * LD + c]);
    const uint32_t h1 = __float_as_uint(bh[r1 * LD + c]);
    if constexpr (SPLIT) {
      const uint32_t l0 = __float_as_uint(bl[r0 * LD + c]);
      const uint32_t l1 = __float_as_uint(bl[r1 * LD + c]);
      mma3(acc[n], ah, al, h0, h1, l0, l1);
    } else {
      mma_tf32(acc[n], al, h0, h1);
      mma_tf32(acc[n], ah, h0, h1);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqLayout<T, D>::NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    T* __restrict__ dq, int bh, int t_q, int t_k, int causal,
                    float scale) {
  using L = DqLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT, LD = L::LD;
  constexpr bool SPLIT = !L::BF16;   // f32 operands need a lo term
  constexpr int NS = BK / 8;         // n-tiles of S and dP per warp
  constexpr int NO = D / 8;          // n-tiles of dq per warp
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                               // [BQ][LD]
  float* sO = sQ + L::Q_FLOATS;                   // dO, [BQ][LD]
  float* sKh = sO + L::Q_FLOATS;                  // [BK][LD]
  float* sKl = sKh + (SPLIT ? L::K_FLOATS : 0);   // f32 only
  float* sVh = sKl + L::K_FLOATS;
  float* sVl = sVh + (SPLIT ? L::K_FLOATS : 0);
  T* rawK = reinterpret_cast<T*>(sVl + L::K_FLOATS);   // [BK][D] each
  T* rawV = rawK + BK * D;

  // heaviest q tiles first: block i -> (q tile n_qt-1-i/bh, head i%bh)
  const int n_qt = (t_q + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
  const int head = (int)(blockIdx.x % bh);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;
  const int64_t qoff = (int64_t)head * t_q * D;
  const int64_t koff = (int64_t)head * t_k * D;

  int n_kt = (t_k + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, t_q) - 1) / BK + 1);

  // tile 0 in flight while Q and dO are staged
  issue_raw<T, BK, D, NT>(rawK, k + koff, 0, t_k);
  issue_raw<T, BK, D, NT>(rawV, v + koff, 0, t_k);
  cp_async_commit();
  load_rows_f32<T, BQ, D, LD, NT>(sQ, q + qoff, q0, t_q);
  load_rows_f32<T, BQ, D, LD, NT>(sO, dout + qoff, q0, t_q);

  const int row_a = q0 + wrow + g;           // this lane's two rows
  const int row_b = row_a + 8;
  const float c = scale * LOG2E;             // scores in log2 units
  float l2[2], dr[2];                        // lse (log2 units) and D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    const bool ok = row < t_q;
    l2[r] = ok ? lse[(int64_t)head * t_q + row] * LOG2E : 0.f;
    dr[r] = ok ? dd[(int64_t)head * t_q + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bool warp_live = q0 + wrow < t_q;
  const float* qa = sQ + (wrow + g) * LD + 2 * t4;
  const float* qb = qa + 8 * LD;
  const float* oa = sO + (wrow + g) * LD + 2 * t4;
  const float* ob = oa + 8 * LD;
  const int pg = perm8(g);                   // key row of B column g
  const int p0 = perm8(2 * t4), p1 = perm8(2 * t4 + 1);   // C columns 2t, 2t+1

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    cp_async_wait_all();
    __syncthreads();            // tile j staged; iteration j-1 is done
    convert_tile<BK, D, LD, NT>(sKh, sKl, rawK);
    convert_tile<BK, D, LD, NT>(sVh, sVl, rawV);
    __syncthreads();            // tiles ready; staging free
    if (j + 1 < n_kt) {         // tile j+1 lands while tile j is multiplied
      issue_raw<T, BK, D, NT>(rawK, k + koff, k0 + BK, t_k);
      issue_raw<T, BK, D, NT>(rawV, v + koff, k0 + BK, t_k);
    }
    cp_async_commit();
    // warp-uniform: nothing of this tile reaches the warp's rows
    if (!warp_live || (causal && k0 > q0 + wrow + 15)) continue;

    // ---- S = Q K^T and dP = dO V^T (16 x BK per warp) ----
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll 1
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      load_a<SPLIT>(qa + kk, qb + kk, qh, ql);
      load_a<SPLIT>(oa + kk, ob + kk, oh, ol);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int at = (n * 8 + pg) * LD + kk + 2 * t4;
        const uint2 kh = *reinterpret_cast<const uint2*>(sKh + at);
        const uint2 vh = *reinterpret_cast<const uint2*>(sVh + at);
        if constexpr (SPLIT) {
          const uint2 kl = *reinterpret_cast<const uint2*>(sKl + at);
          const uint2 vl = *reinterpret_cast<const uint2*>(sVl + at);
          mma3(s[n], qh, ql, kh.x, kh.y, kl.x, kl.y);
          mma3(dp[n], oh, ol, vh.x, vh.y, vl.x, vl.y);
        } else {
          mma_tf32(s[n], qh, kh.x, kh.y);
          mma_tf32(dp[n], oh, vh.x, vh.y);
        }
      }
    }

    // ---- dS = P (dP - D) scale on the fragments: rows g, g+8 ----
    const bool edge = k0 + BK > t_k || (causal && k0 + BK - 1 > q0 + wrow);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? row_b : row_a;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + (e ? p1 : p0);
          float p = exp2f(fmaf(s[n][2 * r + e], c, -l2[r]));
          if (edge && (key >= t_k || (causal && row < key))) p = 0.f;
          s[n][2 * r + e] = p * (dp[n][2 * r + e] - dr[r]) * scale;
        }
      }
    }

    // ---- dq += dS K: dS's C fragment of keys 8jj.. is the A fragment ----
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      uint32_t ah[4], al[4];
      c_to_a(s[jj], ah, al);
      mma_rows<SPLIT, NO, LD>(acc, ah, al, sKh, sKl, jj * 8 + p0, jj * 8 + p1, g);
    }
  }

  T* out = dq + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= t_q) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(out + (int64_t)row * D + n * 8 + 2 * t4, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvLayout<T, D>::NT, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     T* __restrict__ dk, T* __restrict__ dv, int bh, int t_q,
                     int t_k, int causal, float scale) {
  using L = DkvLayout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, NT = L::NT, LD = L::LD;
  constexpr bool SPLIT = !L::BF16;
  constexpr int NQ = BQ / 8;         // n-tiles of S^T and dP^T per warp
  constexpr int NO = D / 8;          // n-tiles of dk and dv per warp
  constexpr int NACC = L::SPLIT_OUT ? 1 : 2;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                               // [BK][LD]
  float* sV = sK + L::K_FLOATS;                   // [BK][LD]
  float* sQh = sV + L::K_FLOATS;                  // [BQ][LD]
  float* sQl = sQh + (SPLIT ? L::Q_FLOATS : 0);   // f32 only
  float* sOh = sQl + L::Q_FLOATS;                 // dO
  float* sOl = sOh + (SPLIT ? L::Q_FLOATS : 0);
  float* sL = sOl + L::Q_FLOATS;                  // [BQ] lse * log2(e)
  float* sD = sL + BQ;                            // [BQ]
  T* rawQ = reinterpret_cast<T*>(sD + BQ);        // [BQ][D] each
  T* rawO = rawQ + BQ * D;

  // heaviest k tiles first: block i -> (k tile i / (bh*NPART), head, part)
  const int per_tile = bh * L::NPART;
  const int kt = (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int head = rem % bh;
  const int part = rem / bh;                 // SPLIT_OUT: 0 -> dv, 1 -> dk
  const bool want_v = !L::SPLIT_OUT || part == 0;
  const bool want_k = !L::SPLIT_OUT || part == 1;
  const int k0 = kt * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp * 16;
  const int tid = threadIdx.x;
  const int64_t qoff = (int64_t)head * t_q * D;
  const int64_t koff = (int64_t)head * t_k * D;
  const float* lse_h = lse + (int64_t)head * t_q;
  const float* dd_h = dd + (int64_t)head * t_q;

  const int n_qt = (t_q + BQ - 1) / BQ;
  // causal: q tile qt is live iff its last row qt*BQ+BQ-1 >= k0
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;

  float nl = 0.f, nd = 0.f;      // lse and D of the next tile's row tid
  if (qt0 < n_qt) {
    issue_raw<T, BQ, D, NT>(rawQ, q + qoff, qt0 * BQ, t_q);
    issue_raw<T, BQ, D, NT>(rawO, dout + qoff, qt0 * BQ, t_q);
    const int row = qt0 * BQ + tid;
    if (tid < BQ && row < t_q) {
      nl = lse_h[row] * LOG2E;
      nd = dd_h[row];
    }
  }
  cp_async_commit();
  load_rows_f32<T, BK, D, LD, NT>(sK, k + koff, k0, t_k);
  if (want_k) load_rows_f32<T, BK, D, LD, NT>(sV, v + koff, k0, t_k);

  const int key_a = k0 + wk + g;             // this lane's two keys
  const int key_b = key_a + 8;
  const float c = scale * LOG2E;
  float acc[NACC][NO][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.f;
  float (&acc_v)[NO][4] = acc[0];
  float (&acc_k)[NO][4] = acc[NACC - 1];
  const bool warp_live = k0 + wk < t_k;
  const float* ka = sK + (wk + g) * LD + 2 * t4;
  const float* kb = ka + 8 * LD;
  const float* va = sV + (wk + g) * LD + 2 * t4;
  const float* vb = va + 8 * LD;
  const int pg = perm8(g);
  const int p0 = perm8(2 * t4), p1 = perm8(2 * t4 + 1);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    cp_async_wait_all();
    __syncthreads();            // tile qt staged; iteration qt-1 is done
    convert_tile<BQ, D, LD, NT>(sQh, sQl, rawQ);
    convert_tile<BQ, D, LD, NT>(sOh, sOl, rawO);
    if (tid < BQ) {
      sL[tid] = nl;
      sD[tid] = nd;
    }
    __syncthreads();            // tiles ready; staging free
    if (qt + 1 < n_qt) {        // tile qt+1 lands while tile qt is multiplied
      issue_raw<T, BQ, D, NT>(rawQ, q + qoff, q0 + BQ, t_q);
      issue_raw<T, BQ, D, NT>(rawO, dout + qoff, q0 + BQ, t_q);
      const int row = q0 + BQ + tid;
      nl = nd = 0.f;
      if (tid < BQ && row < t_q) {
        nl = lse_h[row] * LOG2E;
        nd = dd_h[row];
      }
    }
    cp_async_commit();
    // warp-uniform: every query of this tile comes before the warp's keys
    if (!warp_live || (causal && q0 + BQ - 1 < k0 + wk)) continue;

    // ---- S^T = K Q^T and dP^T = V dO^T (16 keys x BQ queries a warp) ----
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll 1
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      load_a<SPLIT>(ka + kk, kb + kk, kh, kl);
      if (want_k) load_a<SPLIT>(va + kk, vb + kk, vh, vl);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int at = (n * 8 + pg) * LD + kk + 2 * t4;
        const uint2 qh = *reinterpret_cast<const uint2*>(sQh + at);
        if constexpr (SPLIT) {
          const uint2 ql = *reinterpret_cast<const uint2*>(sQl + at);
          mma3(st[n], kh, kl, qh.x, qh.y, ql.x, ql.y);
        } else {
          mma_tf32(st[n], kh, qh.x, qh.y);
        }
        if (want_k) {
          const uint2 oh = *reinterpret_cast<const uint2*>(sOh + at);
          if constexpr (SPLIT) {
            const uint2 ol = *reinterpret_cast<const uint2*>(sOl + at);
            mma3(dpt[n], vh, vl, oh.x, oh.y, ol.x, ol.y);
          } else {
            mma_tf32(dpt[n], vh, oh.x, oh.y);
          }
        }
      }
    }

    // ---- P^T and dS^T on the fragments: keys g, g+8; query columns ----
    const bool edge = q0 + BQ > t_q || (causal && q0 < k0 + wk + 15);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + (e ? p1 : p0);
        const int query = q0 + col;
        const float lq = sL[col], dq_row = sD[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = r ? key_b : key_a;
          float p = exp2f(fmaf(st[n][2 * r + e], c, -lq));
          if (edge && (query >= t_q || (causal && query < key))) p = 0.f;
          st[n][2 * r + e] = p;
          dpt[n][2 * r + e] = p * (dpt[n][2 * r + e] - dq_row) * scale;
        }
      }
    }

    // ---- dv += P^T dO, dk += dS^T Q: the C fragments are the A ones ----
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      uint32_t ah[4], al[4];
      const int r0 = jj * 8 + p0, r1 = jj * 8 + p1;
      if (want_v) {
        c_to_a(st[jj], ah, al);
        mma_rows<SPLIT, NO, LD>(acc_v, ah, al, sOh, sOl, r0, r1, g);
      }
      if (want_k) {
        c_to_a(dpt[jj], ah, al);
        mma_rows<SPLIT, NO, LD>(acc_k, ah, al, sQh, sQl, r0, r1, g);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_b : key_a;
    if (key >= t_k) continue;
    const int64_t at = koff + (int64_t)key * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (want_k) store2(dk + at + n * 8, acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      if (want_v) store2(dv + at + n * 8, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dd,
                      void* dq, int bh, int t_q, int t_k, int causal,
                      float scale, cudaStream_t stream) {
  using L = DqLayout<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)bh * ((t_q + L::BQ - 1) / L::BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, D><<<(unsigned)blocks, L::NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dq), bh, t_q, t_k, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dd,
                       void* dk, void* dv, int bh, int t_q, int t_k,
                       int causal, float scale, cudaStream_t stream) {
  using L = DkvLayout<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)bh * L::NPART * ((t_k + L::BK - 1) / L::BK);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<T, D><<<(unsigned)blocks, L::NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dk), static_cast<T*>(dv), bh, t_q, t_k, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dq_d(int d, const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* dd, void* dq, int bh, int t_q, int t_k,
         int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 64: return (int)launch_dq<T, 64>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
    case 128: return (int)launch_dq<T, 128>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
    case 192: return (int)launch_dq<T, 192>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
    case 256: return (int)launch_dq<T, 256>(q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_d(int d, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* dd, void* dk, void* dv, int bh,
          int t_q, int t_k, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 64: return (int)launch_dkv<T, 64>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
    case 128: return (int)launch_dkv<T, 128>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
    case 192: return (int)launch_dkv<T, 192>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
    case 256: return (int)launch_dkv<T, 256>(q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: 64, 128, 192 or 256.  q, k, v,
// dout, dq, dk, dv contiguous [bh, t, d] and 16-byte aligned; lse and dd
// (= rowsum(dout * out)) f32 [bh, t_q].  Each returns a cudaError_t; 0 is
// success.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* dd, void* dq, int bh, int t_q,
                                 int t_k, int d, int causal, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t_q <= 0 || t_k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dq_d<float>(d, q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1)
    return dq_d<__nv_bfloat16>(d, q, k, v, dout, lse, dd, dq, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* dd, void* dk, void* dv, int bh,
                                  int t_q, int t_k, int d, int causal,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t_q <= 0 || t_k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dkv_d<float>(d, q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  if (dtype == 1)
    return dkv_d<__nv_bfloat16>(d, q, k, v, dout, lse, dd, dk, dv, bh, t_q, t_k, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
