// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu), on sm_90a: asynchronous tile copies, the 3xTF32
// split and product on m16n8k8 TF32 mma.sync, and the fragment loads.
// Each kernel source includes this file once;
// `utils/kernel_build.library_path` hashes it with the source.
//
// m16n8k8 TF32 fragments: lane (g = lane/4, t = lane%4) holds A at (g, t),
// (g+8, t), (g, t+4), (g+8, t+4), B at (k = t, n = g), (t+4, g), and C at
// (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // finite, as in ops/attention.NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo to ~2^-22 relative: hi is x rounded to nearest TF32, lo
// the remainder (exact in f32) rounded to nearest TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// d = a * b on one 16x8x8 TF32 tile (a zero accumulator).
__device__ __forceinline__ void mma_tf32_zc(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d += a * b on one 16x8x8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
  acc[0] += t[0]; acc[1] += t[1]; acc[2] += t[2]; acc[3] += t[3];
}

// acc += a * b at f32 accuracy: lo*hi + hi*lo + hi*hi into a zeroed tile,
// then added in f32.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  float t[4];
  mma_tf32_zc(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
  add4(acc, t);
}

// A fragment of rows g and g+8 at columns (2t, 2t+1) of an f32 tile, as
// 8-byte loads at pa and pb; split into hi and lo, or (bf16 input, exact
// in TF32) its bits in hi.
template <bool SPLIT>
__device__ __forceinline__ void load_a(const float* pa, const float* pb,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float2 xa = *reinterpret_cast<const float2*>(pa);
  const float2 xb = *reinterpret_cast<const float2*>(pb);
  if constexpr (SPLIT) {
    split_tf32(xa.x, h[0], l[0]);
    split_tf32(xb.x, h[1], l[1]);
    split_tf32(xa.y, h[2], l[2]);
    split_tf32(xb.y, h[3], l[3]);
  } else {
    h[0] = __float_as_uint(xa.x);
    h[1] = __float_as_uint(xb.x);
    h[2] = __float_as_uint(xa.y);
    h[3] = __float_as_uint(xb.y);
  }
}

// The C fragment of 8 columns as the A fragment of a k-step over them,
// split into hi and lo.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  split_tf32(c[0], h[0], l[0]);   // (g,   column 2t)
  split_tf32(c[2], h[1], l[1]);   // (g+8, column 2t)
  split_tf32(c[1], h[2], l[2]);   // (g,   column 2t+1)
  split_tf32(c[3], h[3], l[3]);   // (g+8, column 2t+1)
}

__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p, int i) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p + i);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [row0, row0 + ROWS) of a [t, D] global matrix into a dense
// [ROWS][D] staging buffer, issued as cp.async; rows past t read as zero.
template <typename T, int ROWS, int D, int NT>
__device__ __forceinline__ void issue_raw(T* dst, const T* src, int row0, int t) {
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = D / EPC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * EPC;
    const int row = row0 + r;
    const bool ok = row < t;
    cp_async16(dst + r * D + c, src + (int64_t)(ok ? row : 0) * D + c, ok);
  }
}

// Dense staging [ROWS][D] -> f32 tiles with row stride LD: the TF32 hi
// and lo parts of f32 input, or bf16 input widened (exact in TF32, no lo).
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void convert_tile(float* hi, float* lo, const float* src) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * D + c);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + r * LD + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * LD + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void convert_tile(float* hi, float*, const __nv_bfloat16* src) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    float4* o = reinterpret_cast<float4*>(hi + r * LD + c);
    o[0] = widen4(src, r * D + c);
    o[1] = widen4(src, r * D + c + 4);
  }
}

// Rows [row0, row0 + ROWS) of a [t, D] global matrix into an f32 tile
// with row stride LD, zeros past t (synchronous; once per CTA).
template <typename T, int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int row0, int t) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * EPC;
    const int row = row0 + r;
    float* o = dst + r * LD + c;
    if constexpr (IsBf16<T>::value) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (row < t) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)row * D + c);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
        a = widen4(h, 0);
        b = widen4(h, 4);
      }
      reinterpret_cast<float4*>(o)[0] = a;
      reinterpret_cast<float4*>(o)[1] = b;
    } else {
      *reinterpret_cast<float4*>(o) =
          row < t ? *reinterpret_cast<const float4*>(src + (int64_t)row * D + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace
