// The f32 FlashAttention-2 backward pair on Hopper's tensor cores (sm_90a),
// written by hand: `mma.sync` TF32 products in split precision (3xTF32).
//
// Replaces, for f32 operands, two Pallas TPU kernels of
// horovod_tpu/parallel/flash.py:
//   * dq_tf32x3_kernel  <- `_bwd_dq_kernel` (:158, `_run_bwd_kernels`
//                          :319): p = exp(scale * q.k^T - lse),
//                          ds = p * (dO.v^T - delta), dQ = scale * sum_k ds.k;
//   * dkv_tf32x3_kernel <- `_bwd_dkv_kernel` (:195, `_run_bwd_kernels`
//                          :339): dV = sum_q p^T.dO, dK = scale * sum_q ds^T.q.
// They are reached through hvd_flash_bwd_dq / hvd_flash_bwd_dkv
// (flash_attention.cu) whenever an operand is not bf16: f32 models,
// `flash_attention_lse(out_dtype=f32)` (an f32 output cotangent), and the
// f32 step checks.  bf16 operands take flash_attention_bwd_sm90.cu.
//
// Contract (the bf16 pair's): q, k, v, dO and the outputs are [B, S, H, D]
// f32 with the head dim contiguous and 16-byte-multiple strides for B, S
// and H (q/k/v sliced out of the fused qkv projection are read in place);
// lse and delta are f32 [B, H, S]; D is 16, 32, 64 or 128; any S; masks
// NONE, CAUSAL (q >= k), STRICT (q > k) on sequence positions, tiles
// wholly outside the mask never visited; a query row that sees no key
// (STRICT row 0) gets exactly zero gradients; keys and queries at or past
// S contribute exactly 0.  No atomics: every output element is summed in
// a fixed order, so two runs give the same bits.
//
// Numerics.  Every product runs as lo*hi + hi*lo + hi*hi of TF32 parts
// (mma_sync.cuh, shared with the paged prefill route), about 3 * 2^-22 of
// sum |a||b| from the f32 product: well inside the JAX f32 gradient
// tolerance (rtol 2e-3, atol 2e-4), which one TF32 pass (2^-11) would
// break.  P and dS are formed in f32 registers and split like any operand;
// exp is exp2 of the scores times scale * log2(e), as in the bf16 pair.
//
// Bound.  dQ needs 3 products and dK/dV 4, each 2*D flops per (query,
// key) pair the mask keeps, against 5 and 6 [B, S, H, D] f32 operands
// moved.  In 3xTF32 each flop is three on the tensor cores (495 TFLOP/s
// dense): at GPT-2's 1024 causal tokens the operations bound both kernels
// (0.059 / 0.078 ms), at BERT-large's 128 tokens the bytes.  `mma.sync`
// issues well below the dense rate (wgmma's), and each of its products
// here also costs the hi / lo split of its operands (integer operations)
// and their shared-memory loads: the instructions around the products,
// more than the products, are what these kernels wait on.  So the design
// splits each fragment once for as many products as registers allow.
//
// Design.  One block of 4 warps owns a tile of 64 rows and loops over the
// other side's tiles, as the TPU grid's last axis does, with its sums in
// registers.  A warp's rows are whole m16n8k8 row tiles, so the softmax
// needs no exchange between warps:
//   * dq_tf32x3_kernel owns 64 query rows (Q, dO, their lse / delta in
//     registers) and streams key tiles (K, V) up to the last one the mask
//     lets contribute: S = Q.K^T and dP = dO.V^T into accumulators, P and
//     dS formed there, then dQ += dS.K.  For D <= 64 its warps are 2 x 2:
//     each owns 32 rows and half the keys of every tile, so each K / V
//     fragment it splits feeds two row tiles; the two halves' dQ sums are
//     added once, at the end, in a fixed order.  At D = 128 (dQ sums of 64
//     registers a row tile) each warp owns 16 rows and every key.
//   * dkv_tf32x3_kernel owns 64 key rows (K, V), 16 a warp, and streams
//     query tiles (Q, dO, their lse / delta rows) from the first one that
//     sees the key tile; keys are the rows of every product: S^T = K.Q^T
//     and dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q.  Its dK and
//     dV sums take D registers a thread, so the query tile is 64 rows, 32
//     at D = 128, which halves S^T and dP^T there.
// The second products take P / dS straight from the first products'
// accumulator registers: their k index is permuted (lane t4 holds keys, or
// queries, 2*t4 and 2*t4 + 1 of each 8), and the streamed operand's B
// fragment is read in the same order, so nothing goes through shared
// memory.  Every tile is copied by 16-byte `cp.async` into shared memory as
// f32 rows padded by 16 bytes (so both fragment patterns hit 32 distinct
// banks), the streamed side through two stages: the next tile's copies go
// out right after the barrier that frees its stage, before this tile's
// products.  Operands are split into hi / lo when a fragment is read.
// Under a causal mask the tiles' work differs up to S / 64 times, so the
// grid puts the tile index slowest: every (b, h)'s longest tile starts
// before any shorter one, and the short ones fill the end.
// The scale is applied in f32: inside exp2, and to dQ / dK once at the end.
// The tile copies and products are flash_tf32.cuh's, shared with the f32
// forward (flash_attention_fwd_tf32_sm90.cu).

#include "flash_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// dQ: a block per tile of 64 query rows, keys streamed in tiles of 64.
// Grid (H, B, ceil(S/64)).
// ---------------------------------------------------------------------------

template <int D>
struct DqTf32 {
  // The 4 warps are WR row groups x WK key groups: warp (wr, wk) owns MT
  // m-tiles of 16 query rows and the wk-th of WK slices of every key tile,
  // so a K or V fragment, split once, feeds MT products.  At D = 128 the
  // dQ sums alone take 64 registers an m-tile, so there MT = 1.  With
  // WK = 2 the two key groups' partial dQ sums are added at the end,
  // group 0's first.
  static constexpr int MT = D == 128 ? 1 : 2;
  static constexpr int WK = MT, WR = 4 / WK;
  static constexpr int NB = 8 / WK;  // n-tiles of 8 keys of a warp's slice
  static constexpr int T = ROWS * Tf32Tile<D>::RS;  // floats of a tile
  static constexpr size_t bytes = 6 * T * sizeof(float);  // Q, dO, 2 x (K, V)
  static_assert(WR * MT * 16 == ROWS, "the row groups cover the tile");
};

template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1) dq_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Str sq, Str sk, Str sv, Str sd, Str sdq, int S,
    int H, float scale, int mode) {
  using Dq = DqTf32<D>;
  constexpr int MT = Dq::MT, WK = Dq::WK, NB = Dq::NB, T = Dq::T;
  constexpr int RS = Tf32Tile<D>::RS, NKD = Tf32Tile<D>::NKD;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;          // [ROWS][RS]
  float* dos = qs + T;     // [ROWS][RS]
  float* ks = dos + T;     // [2 stages][ROWS][RS]
  float* vs = ks + 2 * T;  // [2 stages][ROWS][RS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp % Dq::WR, wk = warp / Dq::WR;
  // The longest causal rows first, over every (b, h): they loop over the
  // most key tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_k = (key_end(mode, min(q0 + ROWS, S) - 1, S) + ROWS - 1) / ROWS;

  if (n_k > 0) {  // (a block with no key tile issues no copy at all)
    load_rows<D, ROWS>(qs, q, sq, b, h, q0, S);
    load_rows<D, ROWS>(dos, dO, sd, b, h, q0, S);
    load_rows<D, ROWS>(ks, k, sk, b, h, 0, S);
    load_rows<D, ROWS>(vs, v, sv, b, h, 0, S);
  }
  // This lane's rows, r_lo + 16 m and r_lo + 16 m + 8 of the tile, with
  // their lse (in log2 units) and delta; its keys start at kc of a tile.
  const int r_lo = wr * MT * 16 + g, kc = wk * NB * 8;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
  float lr[MT][2], dl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = q0 + r_lo + 16 * m + 8 * j;
      lr[m][j] = r < S ? lse[row_base + r] * LOG2E : 0.f;
      dl[m][j] = r < S ? delta[row_base + r] : 0.f;
    }
  const float sl2 = scale * LOG2E;
  float acc[MT][NKD][4];
  zero<D, MT>(acc);
  const float* q_w = qs + (r_lo - g) * RS;  // this warp's rows
  const float* do_w = dos + (r_lo - g) * RS;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * ROWS;
    const float* kt = ks + (it & 1) * T + kc * RS;  // this warp's keys
    const float* vt = vs + (it & 1) * T + kc * RS;
    // This tile (and, the first time, Q and dO) is in place, and every
    // warp is done with the other stage: its next tile may go out.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_k) {
      load_rows<D, ROWS>(ks + ((it + 1) & 1) * T, k, sk, b, h, k0 + ROWS, S);
      load_rows<D, ROWS>(vs + ((it + 1) & 1) * T, v, sv, b, h, k0 + ROWS, S);
    }

    float s[MT][NB][4], dp[MT][NB][4];
    rows_dot_rows<D, MT, NB>(s, q_w, kt, g, t4);
    rows_dot_rows<D, MT, NB>(dp, do_w, vt, g, t4);

    const bool masked = (mode != MASK_NONE && k0 + ROWS - 1 >= q0)
                        || k0 + ROWS > S || q0 + ROWS > S;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(fmaf(s[m][n][i], sl2, -lr[m][i >> 1]));
          if (masked) {
            const int qp = q0 + r_lo + 16 * m + 8 * (i >> 1);
            const int kp = k0 + kc + n * 8 + 2 * t4 + (i & 1);
            if (!(qp < S && kp < S && keep(mode, qp, kp))) p = 0.f;
          }
          s[m][n][i] = p * (dp[m][n][i] - dl[m][i >> 1]);  // dS
        }
    acc_dot_rows<D, MT, NB>(acc, s, kt, g, t4);
  }
  if (WK == 2) {
    // Key group 1 hands its partial sums to group 0 through the idle K
    // stages; group 0 adds them to its own and stores.
    float* part = ks;  // [ROWS][RS]
    const int c = 2 * t4;
    __syncthreads();  // every warp is done with the stages
    if (wk == 1 && n_k > 0)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int d = 0; d < NKD; ++d)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(
                part + (r_lo + 16 * m + 8 * j) * RS + d * 8 + c) =
                make_float2(acc[m][d][2 * j], acc[m][d][2 * j + 1]);
    __syncthreads();
    if (wk == 1) return;
    if (n_k > 0)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int d = 0; d < NKD; ++d)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 o = *reinterpret_cast<const float2*>(
                part + (r_lo + 16 * m + 8 * j) * RS + d * 8 + c);
            acc[m][d][2 * j] += o.x;
            acc[m][d][2 * j + 1] += o.y;
          }
  }
  store_rows<D, MT>(dq, sdq, b, h, q0 + r_lo - g, S, acc, scale);
}

// ---------------------------------------------------------------------------
// dK, dV: a block per key tile of 64 rows, query tiles of BQ rows streamed.
// Grid (H, B, ceil(S/64)).
// ---------------------------------------------------------------------------

template <int D>
struct DkvTf32 {
  // At D = 128 the dK and dV sums take 128 registers a thread: a query
  // tile of 32 halves S^T and dP^T.
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int TK = ROWS * Tf32Tile<D>::RS;  // owned key tile
  static constexpr int TQ = BQ * Tf32Tile<D>::RS;    // streamed query tile
  // K, V, 2 x (Q, dO), 2 x (lse, delta rows).
  static constexpr size_t bytes = (2 * TK + 4 * TQ + 4 * BQ) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1) dkv_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Str sq, Str sk, Str sv,
    Str sd, Str sdk, Str sdv, int S, int H, float scale, int mode) {
  using Dk = DkvTf32<D>;
  constexpr int BQ = Dk::BQ, TK = Dk::TK, TQ = Dk::TQ;
  constexpr int RS = Tf32Tile<D>::RS, NQ = BQ / 8;  // n-tiles of queries
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;            // [ROWS][RS]
  float* vs = ks + TK;       // [ROWS][RS]
  float* qs = vs + TK;       // [2 stages][BQ][RS]
  float* dos = qs + 2 * TQ;  // [2 stages][BQ][RS]
  float* ls = dos + 2 * TQ;  // [2 stages][BQ] lse
  float* dls = ls + 2 * BQ;  // [2 stages][BQ] delta
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // The first key tiles first, over every (b, h): the most query tiles
  // see them.
  const int k0 = blockIdx.z * ROWS, h = blockIdx.x, b = blockIdx.y;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
  // The query tiles whose keys reach this key tile: from the first one on.
  const int n_q = (S + BQ - 1) / BQ;
  int first = 0;
  while (first < n_q && k0 >= key_end(mode, min((first + 1) * BQ, S) - 1, S))
    ++first;
  const int n_it = n_q - first;

  // Query tile `it` (Q, dO, lse and delta rows) into stage it & 1.
  auto load_q = [&](int it) {
    const int st = it & 1, q0 = (first + it) * BQ;
    load_rows<D, BQ>(qs + st * TQ, q, sq, b, h, q0, S);
    load_rows<D, BQ>(dos + st * TQ, dO, sd, b, h, q0, S);
    if (tid < 2 * BQ) {  // thread t < BQ: lse of query q0 + t; then delta
      const int t = tid % BQ, r = q0 + t;
      cp_async4((tid < BQ ? ls : dls) + st * BQ + t,
                (tid < BQ ? lse : delta) + row_base + (r < S ? r : 0),
                r < S);
    }
  };
  if (n_it > 0) {  // (a block with no query tile issues no copy at all)
    load_rows<D, ROWS>(ks, k, sk, b, h, k0, S);
    load_rows<D, ROWS>(vs, v, sv, b, h, k0, S);
    load_q(0);
  }
  const int kr_lo = warp * 16 + g;  // this lane's key rows: kr_lo, + 8
  const float* k_w = ks + warp * 16 * RS;
  const float* v_w = vs + warp * 16 * RS;
  float gk[1][Tf32Tile<D>::NKD][4], gv[1][Tf32Tile<D>::NKD][4];
  zero<D, 1>(gk);
  zero<D, 1>(gv);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (first + it) * BQ;
    const float* qt = qs + st * TQ;
    const float* dot = dos + st * TQ;
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
    // This tile (and, the first time, K and V) is in place, and every
    // warp is done with the other stage: its next tile may go out.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);

    float s[1][NQ][4], dp[1][NQ][4];
    rows_dot_rows<D, 1, NQ>(s, k_w, qt, g, t4);   // S^T
    rows_dot_rows<D, 1, NQ>(dp, v_w, dot, g, t4);  // dP^T

    const bool masked = (mode != MASK_NONE && q0 <= k0 + ROWS - 1)
                        || q0 + BQ > S || k0 + ROWS > S;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n * 8 + 2 * t4 + (i & 1);
        float p = exp2f((s[0][n][i] * scale - lt[c]) * LOG2E);
        if (masked) {
          const int kp = k0 + kr_lo + 8 * (i >> 1), qp = q0 + c;
          if (!(qp < S && kp < S && keep(mode, qp, kp))) p = 0.f;
        }
        s[0][n][i] = p;                         // P^T
        dp[0][n][i] = p * (dp[0][n][i] - dt[c]);  // dS^T
      }
    acc_dot_rows<D, 1, NQ>(gv, s, dot, g, t4);
    acc_dot_rows<D, 1, NQ>(gk, dp, qt, g, t4);
  }
  store_rows<D, 1>(dk, sdk, b, h, k0 + warp * 16, S, gk, scale);
  store_rows<D, 1>(dv, sdv, b, h, k0 + warp * 16, S, gv, 1.f);
}

// ---------------------------------------------------------------------------
// Host side: launches
// ---------------------------------------------------------------------------

template <int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, const long long* st, int B, int S, int H,
                      float scale, int mode, cudaStream_t stream) {
  const size_t smem = DqTf32<D>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(dq_tf32x3_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dq_tf32x3_kernel<D><<<tile_major(B, S, H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
      static_cast<float*>(dq), str(st, 0), str(st, 1), str(st, 2), str(st, 3),
      str(st, 4), S, H, scale, mode);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* st, int B, int S,
                       int H, float scale, int mode, cudaStream_t stream) {
  const size_t smem = DkvTf32<D>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(dkv_tf32x3_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dkv_tf32x3_kernel<D><<<tile_major(B, S, H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), str(st, 0),
      str(st, 1), str(st, 2), str(st, 3), str(st, 4), str(st, 5), S, H, scale,
      mode);
  return cudaGetLastError();
}

}  // namespace

// Called by hvd_flash_bwd_dq / hvd_flash_bwd_dkv (flash_attention.cu) for
// f32 operands, with their arguments already checked: `strides` holds 3
// element strides (b, s, h) per [B, S, H, D] operand in the C interface's
// order (q, k, v, dO, then the outputs).  Returns the cudaError_t of the
// launch.

int flash_bwd_dq_tf32(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int S, int H,
                      int D, float scale, int mode, cudaStream_t stream) {
  switch (D) {
    case 16: return dq_launch<16>(q, k, v, dO, lse, delta, dq, strides, B, S, H, scale, mode, stream);
    case 32: return dq_launch<32>(q, k, v, dO, lse, delta, dq, strides, B, S, H, scale, mode, stream);
    case 64: return dq_launch<64>(q, k, v, dO, lse, delta, dq, strides, B, S, H, scale, mode, stream);
    case 128: return dq_launch<128>(q, k, v, dO, lse, delta, dq, strides, B, S, H, scale, mode, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int S, int H, int D, float scale, int mode,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return dkv_launch<16>(q, k, v, dO, lse, delta, dk, dv, strides, B, S, H, scale, mode, stream);
    case 32: return dkv_launch<32>(q, k, v, dO, lse, delta, dk, dv, strides, B, S, H, scale, mode, stream);
    case 64: return dkv_launch<64>(q, k, v, dO, lse, delta, dk, dv, strides, B, S, H, scale, mode, stream);
    case 128: return dkv_launch<128>(q, k, v, dO, lse, delta, dk, dv, strides, B, S, H, scale, mode, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
