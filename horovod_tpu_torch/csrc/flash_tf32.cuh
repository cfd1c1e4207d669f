// Tiles, copies and products shared by the f32 flash kernels on the tensor
// cores: flash_attention_fwd_tf32_sm90.cu (the forward) and
// flash_attention_bwd_tf32_sm90.cu (the backward pair).  Each multiplies
// in split-precision TF32 through mma_sync.cuh and takes its addressing,
// masks and launch geometry from sm90.cuh.
//
// Conventions.  A block is 4 warps (NT = 128 threads).  A tile of rows of
// one (b, h) slice sits in shared memory as f32 rows padded by 16 bytes
// (RS = D + 4 floats), so both fragment patterns below hit 32 distinct
// banks.  A warp's rows are whole m16n8k8 row tiles of 16: lane (g, t4) =
// (lane / 4, lane % 4) holds rows g and g + 8 of each.  Operands are split
// into hi / lo when a fragment is read.
//
// Everything here has internal linkage (an unnamed namespace), as in
// sm90.cuh, so each source that includes it gets its own copy.

#pragma once

#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

template <int D>
struct Tf32Tile {
  static constexpr int RS = D + 4;   // floats of a padded row
  static constexpr int NKD = D / 8;  // k-steps along D; n-tiles of the sums
};

// Rows [row0, row0 + R) of one (b, h) slice into dst[R][D + 4] by 16-byte
// cp.async; rows at or past S become zeros.  Thread t copies the piece
// t % (D / 4) of rows t / (D / 4) + j * (NT / (D / 4)), so its address
// moves by a fixed step from one copy to the next.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Str& st, int b, int h,
                                          int row0, int S) {
  constexpr int CPR = D / 4;     // 16-byte pieces of a row
  constexpr int RPT = NT / CPR;  // rows one trip of the block covers
  static_assert(R % RPT == 0, "whole trips");
  const int r = threadIdx.x / CPR, c = (threadIdx.x % CPR) * 4;
  const float* g = src + at(st, b, row0 + r, h) + c;
  const long long step = RPT * st.s;
  float* d = dst + r * Tf32Tile<D>::RS + c;
#pragma unroll
  for (int j = 0; j < R / RPT; ++j) {
    const bool ok = row0 + r + j * RPT < S;
    cp_async16(d + j * RPT * Tf32Tile<D>::RS, ok ? g + j * step : src, ok);
  }
}

// The B fragments of N n-tiles of 8 rows of `b_rows` at k-step kk, split.
template <int D, int N>
__device__ __forceinline__ void split_cols(BFrag (&bf)[N],
                                           const float* b_rows, int kk,
                                           int g, int t4) {
  constexpr int RS = Tf32Tile<D>::RS;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* br = b_rows + (n * 8 + g) * RS + kk * 8 + t4;
    bf[n] = split_b<false>(br[0], br[4]);
  }
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// acc[m][n] = A_m . B_n^T over the head dim for MT m-tiles of 16 rows from
// `a_rows` and N n-tiles of 8 rows from `b_rows`: S = Q.K^T, dP = dO.V^T
// and their transposes.  Each B fragment is split once for all MT m-tiles.
template <int D, int MT, int N>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[MT][N][4],
                                              const float* a_rows,
                                              const float* b_rows, int g,
                                              int t4) {
  constexpr int RS = Tf32Tile<D>::RS;
#pragma unroll
  for (int m = 0; m < MT; ++m) zero_tiles(acc[m]);
#pragma unroll 2
  for (int kk = 0; kk < Tf32Tile<D>::NKD; ++kk) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* x = a_rows + (m * 16 + g) * RS + kk * 8 + t4;
      split_a(x[0], x[8 * RS], x[4], x[8 * RS + 4], hi[m], lo[m]);
    }
    BFrag bf[N];
    split_cols<D, N>(bf, b_rows, kk, g, t4);
#pragma unroll
    for (int m = 0; m < MT; ++m) mma3_tiles<N>(acc[m], hi[m], lo[m], bf);
  }
}

// out[m] += X_m . B, X an accumulator [MT * 16][N * 8] (P or dS, its k
// index permuted: lane t4 holds columns 2*t4 and 2*t4 + 1 of each 8), B
// the N * 8 rows of `b_rows` over the head dim, read in the same order.
template <int D, int MT, int N>
__device__ __forceinline__ void acc_dot_rows(
    float (&out)[MT][Tf32Tile<D>::NKD][4], const float (&x)[MT][N][4],
    const float* b_rows, int g, int t4) {
  constexpr int RS = Tf32Tile<D>::RS, NKD = Tf32Tile<D>::NKD;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      split_a(x[m][j][0], x[m][j][2], x[m][j][1], x[m][j][3], hi[m], lo[m]);
    const float* br = b_rows + (j * 8 + 2 * t4) * RS + g;
    BFrag bf[NKD];
#pragma unroll
    for (int d = 0; d < NKD; ++d)
      bf[d] = split_b<false>(br[d * 8], br[RS + d * 8]);
#pragma unroll
    for (int m = 0; m < MT; ++m) mma3_tiles<NKD>(out[m], hi[m], lo[m], bf);
  }
}

template <int D, int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][D / 8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) zero_tiles(acc[m]);
}

// MT m-tiles of 16 rows from row r0 of a [.. x D] accumulator, times
// `mul`, rows below S only: lane (g, t4) holds rows r0 + 16 m + g (+ 8).
template <int D, int MT>
__device__ __forceinline__ void store_rows(float* out, const Str& st, int b,
                                           int h, int r0, int S,
                                           const float (&acc)[MT][D / 8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + m * 16 + lane / 4 + 8 * half;
      if (r >= S) continue;
      float* o = out + at(st, b, r, h) + 2 * (lane % 4);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<float2*>(o + d * 8) = make_float2(
            acc[m][d][2 * half] * mul, acc[m][d][2 * half + 1] * mul);
    }
}

// Grid (H, B, ceil(S / rows)) with the tile index slowest: blocks start in
// linear order, x fastest, so under a causal mask every (b, h)'s longest
// tile starts before any shorter one (when the kernel maps blockIdx.z to
// its tiles in the order of their work).
dim3 tile_major(int B, int S, int H, int rows = ROWS) {
  return dim3(H, B, (S + rows - 1) / rows);
}

}  // namespace
