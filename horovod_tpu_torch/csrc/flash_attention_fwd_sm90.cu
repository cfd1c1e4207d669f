// The bf16 FlashAttention-2 forward on Hopper's tensor cores (sm_90a),
// written by hand: wgmma products fed by TMA tile copies.
//
// Replaces, for bf16 operands, the Pallas TPU kernel `_fwd_kernel`
// (horovod_tpu/parallel/flash.py:125, launched by `_flash_fwd` :268):
// out = softmax(mask(scale * q.k^T)) . v and lse = m + log l per query
// row, an online softmax over key tiles with the running max floored at
// NEG_INF/2 and the sum at 1e-30.  It is reached through hvd_flash_fwd
// (flash_attention.cu) when q, k and v are all bf16; the f32 instances
// take flash_attention_fwd_tf32_sm90.cu, whose split-precision TF32
// products hold the JAX f32 forward tolerance (one TF32 pass would not).
//
// Contract (the f32 forward's too): q, k, v and out are [B, S, H, D] with
// the head dim contiguous and 16-byte-multiple strides for B, S and H
// (q/k/v sliced out of the fused qkv projection are read in place); lse
// is f32 [B, H, S]; D is 16, 32, 64 or 128; any S; masks NONE, CAUSAL
// (q >= k), STRICT (q > k) on sequence positions.  A query row that sees
// no key (STRICT row 0) gives out 0 and lse = NEG_INF/2 + log(1e-30),
// which is NEG_INF/2 in f32, at any tile size: the running max starts at
// the floor and is kept in natural-log units, so a row no key reaches
// keeps exactly that value.  No atomics: each output element is summed by
// one thread in a fixed order, so two runs give the same bits.
//
// Bound.  Two products, 2*D flops each per (query, key) pair the mask
// keeps, against 4 [B, S, H, D] bf16 operands moved (q, k, v, out) and
// lse.  At BERT-large [32, 128, 16, 64] the bytes bound it: 33.8 MB at
// 3.35 TB/s is 10.1 us, against 2.15 GFLOP at 989 TFLOP/s, 2.2 us.  At
// GPT-2's 1024 causal tokens [4, 1024, 12, 64] the two are close: 25.4 MB
// is 7.6 us and 6.45 GFLOP is 6.5 us on the bf16 tensor cores (39 us as
// the three TF32 passes of the f32 forward, 96 us on the f32 FMA pipe).
// So the products go to the tensor cores and every operand is read from
// device memory once per tile, asynchronously, with no f32 staging.
//
// Design.  One block of 128 threads (one warpgroup) owns 64 query rows and
// streams the key tiles up to the last one the mask lets contribute, as
// the TPU grid's last axis does, with the softmax state and the output in
// registers (dq_kernel's skeleton in flash_attention_bwd_sm90.cu):
//   * Q is loaded once by TMA; K and V come through a two-stage ring, and
//     the first two key tiles' copies are issued with Q's, so they overlap
//     it; each later tile's copy is issued as soon as its stage is free,
//     so it overlaps the products and the softmax of the tile before.
//   * S = Q.K^T is wgmma from shared memory (both operands K-major).  Its
//     f32 accumulator holds two rows a thread, each spread over the 4
//     lanes of a quad, so a row's max is two quad shuffles.  The scale is
//     folded with log2(e) into S in f32 inside exp2, never applied to a
//     bf16 tile.  O is rescaled in registers by exp2(m_old - m_new).
//   * P is rounded to bf16 in the accumulator's registers and fed back as
//     wgmma's register A operand against V read with the transpose bit
//     (MN-major), as dS.K is in dq_kernel.  The row sum l is taken from
//     the f32 P before that rounding (each thread keeps a partial sum over
//     its columns; the quad adds them once, at the end), so lse keeps the
//     f32 tolerance.  The one rounding this adds to the plain version's
//     f32 arithmetic: P enters P.V as bf16
//     (flash.attention_fwd_rounding_bound).
//   * Epilogue: out = acc / max(l, 1e-30) rounded to bf16, staged through
//     the (then idle) K ring with a padded row stride and written with
//     16-byte stores, columns below D only; lse = m + log l in natural log.
//   * Masks: key tiles wholly outside the mask are never visited (key_end,
//     as block_contributes); the mask is applied element by element only
//     on tiles the diagonal crosses or S cuts.  TMA zero-fills keys past S
//     (a score of 0, not -inf), so those are masked before the max; the
//     zero-filled head-dim columns of D = 16 or 32 in a 64-column chunk
//     add exactly 0 to S and to O and are not stored.
//
// Why one warpgroup per 64 rows, and not two consumer warpgroups on a
// 128-row tile sharing one K/V ring (or a separate producer warp): at
// BERT-large each (b, h) has only 2 key tiles, so the time goes to copy
// latency and block start-up more than to the products.  64-row blocks
// give 1024 independent blocks at BERT-large (512 with 128 rows), each of
// 42 KB of shared memory and 106 registers a thread at D = 64, so 4 run
// on an SM and one block's copies overlap another's products; the shared
// ring would halve the K/V reads from L2, not from device memory.  The
// longest causal rows start first.

#include <math_constants.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

template <int D>
struct FwdShape {
  static constexpr int T = Shape<D>::NCH * ROWS * CH;  // elements of a tile
  // Row stride (bf16) of the output tile staged for the 16-byte stores:
  // 16 bytes past the row keeps the quad's 4-byte writes on 32 banks.
  static constexpr int OS = Shape<D>::DP + 8;
  static constexpr size_t bytes = 5 * T * sizeof(bf16) + 3 * 8 + 1024;
  // At D = 128 the O accumulator is 64 registers a thread and the tiles
  // take 81 KB: two blocks an SM.  Below, three at least.
  static constexpr int MIN_BLOCKS = D == 128 ? 2 : 3;
  static_assert(ROWS * OS <= 2 * T, "the output tile fits the K ring");
};

// out [B, S, H, D] bf16, lse [B, H, S] f32.  Grid (ceil(S/64), H, B).
template <int D>
__global__ void __launch_bounds__(NT, FwdShape<D>::MIN_BLOCKS) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, Str so,
    float* __restrict__ lse, int S, int H, float scale, int mode) {
  using Sh = Shape<D>;
  using Fw = FwdShape<D>;
  constexpr int T = Fw::T;
  constexpr uint32_t TILE_BYTES = T * sizeof(bf16);
  bf16* qs = reinterpret_cast<bf16*>(smem_base());
  bf16* ks = qs + T;       // [2 stages][T]
  bf16* vs = ks + 2 * T;   // [2 stages][T]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * T);  // q, kv0, kv1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // The longest causal rows first: they loop over the most key tiles.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_k = (key_end(mode, min(q0 + ROWS, S) - 1, S) + ROWS - 1) / ROWS;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int it) {
    uint64_t* bar = &bars[1 + (it & 1)];
    mbar_expect(bar, 2 * TILE_BYTES);
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) {
      tma_load(ks + (it & 1) * T + c * ROWS * CH, &tk, bar, c * CH, h,
               it * ROWS, b);
      tma_load(vs + (it & 1) * T + c * ROWS * CH, &tv, bar, c * CH, h,
               it * ROWS, b);
    }
  };
  if (tid == 0 && n_k > 0) {
    mbar_expect(&bars[0], TILE_BYTES);
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c)
      tma_load(qs + c * ROWS * CH, &tq, &bars[0], c * CH, h, q0, b);
    load_kv(0);
    if (n_k > 1) load_kv(1);
  }
  // This thread's two rows, r_lo and r_lo + 8: running max m (natural
  // log, floored at NEG_INF/2 from the start) and its partial sum l.
  const int r_lo = warp * 16 + lane / 4;
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF * 0.5f, NEG_INF * 0.5f}, l[2] = {0.f, 0.f};
  float acc[Sh::NCH][32];
#pragma unroll
  for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  if (n_k > 0) mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * ROWS;
    const bf16* kt = ks + (it & 1) * T;
    const bf16* vt = vs + (it & 1) * T;
    mbar_wait(&bars[1 + (it & 1)], (it >> 1) & 1);

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk)
      wgmma_ss(s, desc_kmajor<ROWS>(qs, kk), desc_kmajor<ROWS>(kt, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    if ((mode != MASK_NONE && k0 + ROWS - 1 >= q0) || k0 + ROWS > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = q0 + r_lo + 8 * rsel(i), kp = k0 + col(i, lane);
        if (!(kp < S && keep(mode, qp, kp))) s[i] = -CUDART_INF_F;
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, m2[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[rsel(i)] = fmaxf(mx[rsel(i)], s[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j] * scale);
      const float corr = exp2f((m[j] - m_new) * LOG2E);
      m[j] = m_new;
      m2[j] = m_new * LOG2E;
      l[j] *= corr;
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (rsel(i) == j) acc[c][i] *= corr;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(fmaf(s[i], sl2, -m2[rsel(i)]));  // P, f32
      l[rsel(i)] += s[i];
    }
    uint32_t a[4][4];
    to_a(s, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c)
        wgmma_rs(acc[c], a[kk], desc_mnmajor<ROWS>(vt, c, kk));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) fence_regs(acc[c]);
    if (it + 2 < n_k) {
      __syncthreads();  // every thread is done with this stage
      if (tid == 0) load_kv(it + 2);
    }
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = fmaxf(l[j], 1e-30f);
    inv[j] = 1.f / l[j];
  }
  __syncthreads();  // no product reads the K ring any more
  bf16* os = ks;    // [ROWS][OS]
#pragma unroll
  for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = r_lo + 8 * rsel(i);
      *reinterpret_cast<__nv_bfloat162*>(os + r * Fw::OS + c * CH
                                         + col(i, lane)) =
          __floats2bfloat162_rn(acc[c][i] * inv[rsel(i)],
                                acc[c][i + 1] * inv[rsel(i)]);
    }
  __syncthreads();
  constexpr int VPR = D / 8;  // 16-byte vectors in a row of D bf16
  for (int e = tid; e < ROWS * VPR; e += NT) {
    const int r = e / VPR, cv = (e % VPR) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(out + at(so, b, q0 + r, h) + cv) =
          *reinterpret_cast<const uint4*>(os + r * Fw::OS + cv);
  }
  if ((lane & 3) == 0) {
    const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = q0 + r_lo + 8 * j;
      if (r < S) lse[row_base + r] = m[j] + logf(l[j]);
    }
  }
}

template <int D>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* st, int B, int S, int H,
                       float scale, int mode, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, st, B, S, H, D, ROWS)
      || !make_map(&mk, k, st + 3, B, S, H, D, ROWS)
      || !make_map(&mv, v, st + 6, B, S, H, D, ROWS))
    return cudaErrorInvalidValue;
  const size_t smem = FwdShape<D>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<D><<<grid(B, S, H), NT, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), str(st, 3), lse, S, H, scale,
      mode);
  return cudaGetLastError();
}

}  // namespace

// Called by hvd_flash_fwd (flash_attention.cu) for bf16 operands, with its
// arguments already checked: `strides` holds 3 element strides (b, s, h)
// for q, k, v and out, in that order.  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue if a tensor map cannot be encoded.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* strides, int B, int S, int H,
                   int D, float scale, int mode, cudaStream_t stream) {
  switch (D) {
    case 16: return fwd_launch<16>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 32: return fwd_launch<32>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 64: return fwd_launch<64>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
    case 128: return fwd_launch<128>(q, k, v, out, lse, strides, B, S, H, scale, mode, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
