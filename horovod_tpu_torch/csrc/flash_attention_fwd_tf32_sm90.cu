// The f32 FlashAttention-2 forward on Hopper's tensor cores (sm_90a),
// written by hand: `mma.sync` TF32 products in split precision (3xTF32).
//
// Replaces, for f32 operands, the Pallas TPU kernel `_fwd_kernel`
// (horovod_tpu/parallel/flash.py:125, launched by `_flash_fwd` :268):
// out = softmax(mask(q * scale . k^T)) . v and lse = m + log l per query
// row, an online softmax over key tiles with the running max floored at
// NEG_INF/2 and the sum at 1e-30.  It is reached through hvd_flash_fwd
// (flash_attention.cu) whenever q, k or v is not bf16: f32 models,
// `flash_attention_lse(out_dtype=f32)` (which casts q, as JAX does, so
// every ring hop's partial comes from here), and the f32 step checks.
// All-bf16 operands take flash_attention_fwd_sm90.cu.
//
// Contract (the bf16 forward's): q, k, v and out are [B, S, H, D] f32
// with the head dim contiguous and 16-byte-multiple strides for B, S and H
// (q/k/v sliced out of the fused qkv projection are read in place); lse is
// f32 [B, H, S]; D is 16, 32, 64 or 128; any S; masks NONE, CAUSAL
// (q >= k), STRICT (q > k) on sequence positions, key tiles wholly outside
// the mask never visited.  A query row that sees no key (STRICT row 0)
// gives out exactly 0 and lse = NEG_INF/2 + log(1e-30), which is NEG_INF/2
// in f32, at any tile size: the running max starts at the floor and is
// kept in natural-log units, so a row no key reaches keeps exactly that
// value.  No atomics: every output element is summed in a fixed order, so
// two runs give the same bits.
//
// Numerics.  Both products, S = Q.K^T and O += P.V, run as lo*hi + hi*lo +
// hi*hi of TF32 parts (mma_sync.cuh), about 3 * 2^-22 of sum |a||b| from
// the f32 product: inside the JAX f32 forward tolerance (rtol 2e-4, atol
// 2e-5), which one TF32 pass (2^-11) would break.  The softmax stays in
// f32: the scale is applied to S inside exp2 (exp2(s * scale * log2 e -
// m * log2 e)), the max is compared as s * scale, and P is split like any
// operand.  out = O * (1 / max(l, 1e-30)).
//
// Bound.  Two products, 2*D flops each per (query, key) pair the mask
// keeps, three TF32 passes each on the tensor cores (495 TFLOP/s dense),
// against 4 [B, S, H, D] f32 operands moved (q, k, v, out) and lse.  At
// GPT-2's 1024 causal tokens [4, 1024, 12, 64] the operations bound it:
// 3 x 6.45 GFLOP is 39.1 us, the 50.5 MB 15.1 us.  At BERT-large
// [32, 128, 16, 64] the bytes: 67.4 MB at 3.35 TB/s is 20.1 us, 3 x 2.15
// GFLOP 13.0 us.  As in the backward pair, `mma.sync` issues well below
// the dense rate, and the hi / lo split of each fragment (integer
// operations) and its shared-memory loads, more than the products, are
// what the kernel waits on.  So it splits each fragment once for as many
// products as registers allow.
//
// Design (the backward pair's, flash_tf32.cuh).  One block of 4 warps owns
// a tile of query rows, 16 * MT a warp, and streams the key tiles of 64
// rows up to the last one the mask lets contribute, as the TPU grid's last
// axis does, with the softmax state and O in registers.  A warp's rows are
// whole m16n8k8 row tiles, so a row's max and sum reduce over the 4 lanes
// that hold it (two quad shuffles) and no warp waits on another's rows.
//   * MT = 2 (128-row tiles) at D <= 64: each K / V fragment, split once,
//     feeds two row tiles, and Q is split from shared memory at every key
//     tile (128 registers would not fit beside O and S).  The keys are not
//     split across warps, which would need a merge of (m, l, O) between
//     them.  A warp skips a key tile its rows see nothing of (the
//     diagonal's second tile under a causal mask), which leaves its state
//     as it was, bit for bit.  (64-row tiles with a warp's Q split once,
//     before the key loop, measured no faster: PERF.md.)
//   * MT = 1 (64-row tiles) at D = 128, where O alone takes 64 registers.
//   * K and V stream by 16-byte `cp.async` into two stages of padded rows;
//     the next tile's copies go out right after the barrier that frees its
//     stage, before this tile's products.
//   * Per key tile: S = Q.K^T into accumulators; the mask only on tiles the
//     diagonal crosses or S cuts; m_new = max(m, rowmax(s) * scale),
//     corr = exp2((m - m_new) log2 e), P = exp2(s * scale * log2 e -
//     m_new * log2 e), l and O scaled by corr and l += P (each lane keeps
//     its partial sum over its columns; the quad adds them once, at the
//     end); then O += P.V with P straight from the accumulator registers
//     (acc_dot_rows: the permuted k index, V's B fragment read in the same
//     order).
//   * Under a causal mask the tiles' work differs up to S / 64 times, so
//     the grid is (H, B, tiles) with the tile index slowest and reversed:
//     every (b, h)'s longest tile starts first, the short ones fill the end.
//   * Epilogue: O times 1 / max(l, 1e-30) by float2 stores, rows below S;
//     lse = m + log(max(l, 1e-30)) in natural-log units.

#include <math_constants.h>

#include "flash_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

template <int D, int MT>
struct FwdTf32 {
  static constexpr int BQ = 4 * 16 * MT;  // query rows of a block
  static constexpr int TQ = BQ * Tf32Tile<D>::RS;    // Q tile
  static constexpr int TK = ROWS * Tf32Tile<D>::RS;  // K or V stage
  static constexpr size_t bytes = (TQ + 4 * TK) * sizeof(float);  // Q, 2 x (K, V)
};

// out [B, S, H, D], lse [B, H, S].  Grid (H, B, ceil(S / BQ)).
template <int D, int MT>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1) fwd_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, Str sq, Str sk, Str sv, Str so, int S, int H,
    float scale, int mode) {
  using Fw = FwdTf32<D, MT>;
  constexpr int BQ = Fw::BQ, TK = Fw::TK;
  constexpr int RS = Tf32Tile<D>::RS, NKD = Tf32Tile<D>::NKD;
  constexpr int NB = ROWS / 8;  // n-tiles of 8 keys in a key tile
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;            // [BQ][RS]
  float* ks = qs + Fw::TQ;   // [2 stages][ROWS][RS]
  float* vs = ks + 2 * TK;   // [2 stages][ROWS][RS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // The longest causal rows first, over every (b, h): they loop over the
  // most key tiles.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_k = (key_end(mode, min(q0 + BQ, S) - 1, S) + ROWS - 1) / ROWS;
  // This warp's rows start at w0 of the tile; the keys they may see end
  // at w_end (none for rows wholly past S).
  const int w0 = warp * 16 * MT, qw = q0 + w0;
  const int w_end = qw < S ? key_end(mode, min(qw + 16 * MT, S) - 1, S) : 0;

  if (n_k > 0) {  // (a block with no key tile issues no copy at all)
    load_rows<D, BQ>(qs, q, sq, b, h, q0, S);
    load_rows<D, ROWS>(ks, k, sk, b, h, 0, S);
    load_rows<D, ROWS>(vs, v, sv, b, h, 0, S);
  }
  const float* q_w = qs + w0 * RS;  // this warp's rows
  // Lane (g, t4) holds rows qw + 16 m + g + 8 j: running max m (natural
  // log, floored at NEG_INF/2 from the start) and its partial sum l.
  float mr[MT][2], l[MT][2], acc[MT][NKD][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mr[m][j] = NEG_INF * 0.5f;
      l[m][j] = 0.f;
    }
  zero<D, MT>(acc);
  const float sl2 = scale * LOG2E;

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * ROWS;
    const float* kt = ks + (it & 1) * TK;
    const float* vt = vs + (it & 1) * TK;
    // This tile (and, the first time, Q) is in place, and every warp is
    // done with the other stage: its next tile may go out.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_k) {
      load_rows<D, ROWS>(ks + ((it + 1) & 1) * TK, k, sk, b, h, k0 + ROWS, S);
      load_rows<D, ROWS>(vs + ((it + 1) & 1) * TK, v, sv, b, h, k0 + ROWS, S);
    }
    if (k0 >= w_end) continue;  // (warp-uniform) no key here for these rows

    float s[MT][NB][4];
    rows_dot_rows<D, MT, NB>(s, q_w, kt, g, t4);

    if ((mode != MASK_NONE && k0 + ROWS - 1 >= qw) || k0 + ROWS > S) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qp = qw + 16 * m + g + 8 * (i >> 1);
            const int kp = k0 + n * 8 + 2 * t4 + (i & 1);
            if (!(kp < S && keep(mode, qp, kp))) s[m][n][i] = -CUDART_INF_F;
          }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[m][n][2 * j], s[m][n][2 * j + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(mr[m][j], mx * scale);
        const float corr = exp2f((mr[m][j] - m_new) * LOG2E);
        const float m2 = m_new * LOG2E;
        mr[m][j] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 2 * j; i < 2 * j + 2; ++i) {
            s[m][n][i] = exp2f(fmaf(s[m][n][i], sl2, -m2));  // P, f32
            sum += s[m][n][i];
          }
        l[m][j] = l[m][j] * corr + sum;
#pragma unroll
        for (int d = 0; d < NKD; ++d) {
          acc[m][d][2 * j] *= corr;
          acc[m][d][2 * j + 1] *= corr;
        }
      }
    acc_dot_rows<D, MT, NB>(acc, s, vt, g, t4);
  }

  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float lf = l[m][j];
      lf += __shfl_xor_sync(0xffffffffu, lf, 1);
      lf += __shfl_xor_sync(0xffffffffu, lf, 2);
      lf = fmaxf(lf, 1e-30f);
      const float inv = 1.f / lf;
#pragma unroll
      for (int d = 0; d < NKD; ++d) {
        acc[m][d][2 * j] *= inv;
        acc[m][d][2 * j + 1] *= inv;
      }
      const int r = qw + 16 * m + g + 8 * j;
      if (t4 == 0 && r < S) lse[row_base + r] = mr[m][j] + logf(lf);
    }
  store_rows<D, MT>(out, so, b, h, qw, S, acc, 1.f);
}

template <int D, int MT>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* st, int B, int S, int H,
                       float scale, int mode, cudaStream_t stream) {
  const size_t smem = FwdTf32<D, MT>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(fwd_tf32x3_kernel<D, MT>, smem, smem_set);
  if (e != cudaSuccess) return e;
  fwd_tf32x3_kernel<D, MT>
      <<<tile_major(B, S, H, FwdTf32<D, MT>::BQ), NT, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), lse,
          str(st, 0), str(st, 1), str(st, 2), str(st, 3), S, H, scale, mode);
  return cudaGetLastError();
}

}  // namespace

// Called by hvd_flash_fwd (flash_attention.cu) for f32 operands, with its
// arguments already checked: `strides` holds 3 element strides (b, s, h)
// for q, k, v and out, in that order.  Returns the cudaError_t of the
// launch.
int flash_fwd_tf32(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* strides, int B, int S, int H,
                   int D, float scale, int mode, cudaStream_t stream) {
  switch (D) {
    case 16: return fwd_launch<16, 2>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 32: return fwd_launch<32, 2>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 64: return fwd_launch<64, 2>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 128: return fwd_launch<128, 1>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
