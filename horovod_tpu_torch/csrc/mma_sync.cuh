// Building blocks of the kernels that multiply on the tensor cores through
// `mma.sync` in split-precision TF32: paged_attention_prefill_sm90.cu (B4's
// prefill route), flash_attention_fwd_tf32_sm90.cu and
// flash_attention_bwd_tf32_sm90.cu (the f32 flash forward and backward
// pair, through flash_tf32.cuh).  All round and multiply with these same
// helpers, so an f32 product carries the same error in every kernel that
// makes one.
//
// Numerics.  One TF32 product rounds each operand to 11 significant bits
// (2^-11), which breaks the JAX package's f32 tolerances.  So every f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and each
// product is lo*hi + hi*lo + hi*hi accumulated in f32 by the tensor core
// (CUTLASS's "fast f32"): the dropped lo*lo and the rounding of the two lo
// parts leave about 3 * 2^-22 of sum |a||b| per product, on top of what
// the f32 sums themselves round.  A value that is a TF32 value already
// (bf16, int8, fp8) is its own hi and has no lo: two passes.
//
// Everything here has internal linkage (an unnamed namespace), as in
// sm90.cuh, so each source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes from global to shared memory; zero-filled (nothing read) when
// !ok.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory; zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// x rounded to TF32 as f32 bits: to nearest on the 13 low mantissa bits,
// ties away from zero, as cvt.rna.tf32.f32 rounds (finite x).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi) (the
// subtraction is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product with f32 accumulation.  Fragments
// of lane (g, t4) = (lane / 4, lane % 4): a0..a3 hold A rows g, g + 8,
// g, g + 8 at columns t4, t4, t4 + 4, t4 + 4; b0, b1 hold B rows t4 and
// t4 + 4 of column g; d0..d3 hold rows g, g, g + 8, g + 8 at columns
// 2*t4, 2*t4 + 1, 2*t4, 2*t4 + 1.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment (two f32 values) split once: an exact (TF32-valued) value
// is its own hi and has no lo.
struct BFrag {
  uint32_t h0, h1, l0, l1;
};
template <bool kExactB>
__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag f;
  if (kExactB) {
    f.h0 = __float_as_uint(b0);
    f.h1 = __float_as_uint(b1);
  } else {
    split_tf32(b0, f.h0, f.l0);
    split_tf32(b1, f.h1, f.l1);
  }
  return f;
}

// An A fragment (four f32 values, in a0..a3 order) split once.
__device__ __forceinline__ void split_a(float x0, float x1, float x2,
                                        float x3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

// d += a * b in split precision: lo*hi, hi*lo (not for an exact b), then
// hi*hi, the small terms first.
template <bool kExactB>
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi,
                                     const uint32_t* alo, const BFrag& b) {
  mma(d, alo, b.h0, b.h1);
  if (!kExactB) mma(d, ahi, b.l0, b.l1);
  mma(d, ahi, b.h0, b.h1);
}

// d[n] += a * b[n] for N independent n-tiles in split precision, pass by
// pass: every n-tile's lo*hi, then every hi*lo, then every hi*hi.  Each
// sum takes its terms in mma3's order (the same bits), but N products
// stand between two that feed the same accumulator, which hides the
// tensor core's latency.
template <int N>
__device__ __forceinline__ void mma3_tiles(float (&d)[N][4],
                                           const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const BFrag (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], alo, b[n].h0, b[n].h1);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ahi, b[n].l0, b[n].l1);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ahi, b[n].h0, b[n].h1);
}

}  // namespace
