// The bf16 FlashAttention-2 backward pair on Hopper's tensor cores
// (sm_90a), written by hand: wgmma products fed by TMA tile copies.
//
// Replaces, for bf16 operands, two Pallas TPU kernels of
// horovod_tpu/parallel/flash.py:
//   * dq_kernel  <- `_bwd_dq_kernel` (:158, `_run_bwd_kernels` :319):
//                   p = exp(scale * q.k^T - lse), ds = p * (dO.v^T - delta),
//                   dQ = scale * sum_k ds . k;
//   * dkv_kernel <- `_bwd_dkv_kernel` (:195, `_run_bwd_kernels` :339):
//                   dV = sum_q p^T . dO, dK = scale * sum_q ds^T . q.
// They are reached through hvd_flash_bwd_dq / hvd_flash_bwd_dkv
// (flash_attention.cu) when every operand is bf16; f32 operands run
// flash_attention_bwd_tf32_sm90.cu, `mma.sync` TF32 in split precision,
// whose three passes a product hold the JAX f32 gradient tolerance (one
// TF32 pass would not).
// The PTX, TMA and layout helpers are in sm90.cuh, shared with the
// forward (flash_attention_fwd_sm90.cu).
//
// Contract (the f32 kernels' too): q, k, v, dO and the outputs are
// [B, S, H, D] with the head dim contiguous and 16-byte-multiple strides
// for B, S and H (q/k/v sliced out of the fused qkv projection are read in
// place); lse and delta are f32 [B, H, S]; D is 16, 32, 64 or 128; any S;
// masks NONE, CAUSAL (q >= k), STRICT (q > k) on sequence positions; a
// query row that sees no key (STRICT row 0) gets exactly zero gradients;
// keys and queries at or past S contribute exactly 0.  No atomics: each
// output element is summed by one thread in a fixed order, so two runs
// give the same bits.
//
// Bound.  dQ needs 3 products and dK/dV 4, each 2*D flops per (query,
// key) pair the mask keeps, against 5 and 6 [B, S, H, D] bf16 operands
// moved.  At BERT-large's 128 tokens the bytes bound both kernels (the
// tensor cores would need > 295 flops per byte); at GPT-2's 1024 causal
// tokens the bf16 tensor-core rate does.  So the products go to the
// tensor cores and every operand is read from device memory once per
// tile, asynchronously, with no f32 staging.
//
// Design.  One block of 128 threads (one warpgroup) owns a tile of 64
// rows and loops over the other side's tiles, as the TPU grid's last axis
// does, with its sums in registers:
//   * dq_kernel owns 64 query rows (Q, dO, their lse/delta rows) and
//     streams key tiles (K, V) up to the last one the mask lets
//     contribute; S = Q.K^T and dP = dO.V^T, then dQ += dS.K;
//   * dkv_kernel owns 64 key rows (K, V) and streams the query tiles
//     (Q, dO and their lse/delta rows) from the first one that sees the
//     key tile; keys are the rows of every product: S^T = K.Q^T and
//     dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q.
// Operands stay bf16 in shared memory, in 64-column (128-byte) chunks
// with the 128-byte swizzle that wgmma reads; a head dim below 64 is
// zero-padded to one chunk (those columns add nothing and are not
// stored).  The first products read both operands from shared memory;
// their f32 accumulators hold S and dP in wgmma's register layout, which
// is also the layout of wgmma's register A operand, so P and dS are
// computed in registers, rounded to bf16 and fed straight back as A, with
// the second operand read from shared memory with the transpose bit.  The
// scale is applied to S in f32 (inside exp2) and to dQ / dK once at the
// end, never to a bf16 tile.  The one rounding this adds to the plain
// versions: P and dS enter the second products as bf16.
//
// Copies.  TMA with an mbarrier per buffer: one 4-D tensor map
// (D, H, S, B) per strided operand, encoded on the host per launch
// through cudaGetDriverEntryPoint("cuTensorMapEncodeTiled") (so the
// library needs no -lcuda).  Chosen over 16-byte cp.async because the
// hardware writes the 128-byte swizzle itself, zero-fills the ragged edge
// past S (and the padded head-dim columns), and spends no registers or
// instructions of the warpgroup on addresses, which the accumulators need.
// The streamed side runs through a ring of two stages: thread 0 issues
// the next tile's copy before the products on this one.  The lse / delta
// rows of a streamed query tile (dkv_kernel) are loaded into registers a
// tile ahead and stored into the same ring; a TMA row map would need S to
// be a multiple of 4.
//
// Mask work: tiles wholly outside the mask are never visited (key_end and
// block_contributes, as in the forward), and the mask is applied
// element by element only on tiles the diagonal crosses or the sequence
// end cuts.

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// dQ: a block per query tile, keys streamed.  Grid (ceil(S/64), H, B).
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int T = Shape<D>::NCH * ROWS * CH;  // elements of a tile
  static constexpr size_t bytes = 6 * T * sizeof(bf16) + 3 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, Str sdq, int S,
    int H, float scale, int mode) {
  using Sh = Shape<D>;
  constexpr int T = DqSmem<D>::T;
  constexpr uint32_t TILE_BYTES = T * sizeof(bf16);
  bf16* qs = reinterpret_cast<bf16*>(smem_base());
  bf16* dos = qs + T;
  bf16* ks = dos + T;      // [2 stages][T]
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
  if (tid == 0) {
    mbar_expect(&bars[0], 2 * TILE_BYTES);
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) {
      tma_load(qs + c * ROWS * CH, &tq, &bars[0], c * CH, h, q0, b);
      tma_load(dos + c * ROWS * CH, &tdo, &bars[0], c * CH, h, q0, b);
    }
    if (n_k > 0) load_kv(0);
  }
  // This thread's two rows, and their lse (in log2 units) and delta.
  const int r_lo = warp * 16 + lane / 4;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
  float lse2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = q0 + r_lo + 8 * j;
    lse2[j] = r < S ? lse[row_base + r] * LOG2E : 0.f;
    dl[j] = r < S ? delta[row_base + r] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  float acc[Sh::NCH][32];
#pragma unroll
  for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * ROWS;
    const bf16* kt = ks + (it & 1) * T;
    const bf16* vt = vs + (it & 1) * T;
    __syncthreads();  // every thread is done with the other stage
    if (tid == 0 && it + 1 < n_k) load_kv(it + 1);
    mbar_wait(&bars[1 + (it & 1)], (it >> 1) & 1);

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk)
      wgmma_ss(s, desc_kmajor<ROWS>(qs, kk), desc_kmajor<ROWS>(kt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk)
      wgmma_ss(dp, desc_kmajor<ROWS>(dos, kk), desc_kmajor<ROWS>(vt, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = (mode != MASK_NONE && k0 + ROWS - 1 >= q0)
                        || k0 + ROWS > S || q0 + ROWS > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(s[i], sl2, -lse2[rsel(i)]));
      if (masked) {
        const int qp = q0 + r_lo + 8 * rsel(i), kp = k0 + col(i, lane);
        if (!(qp < S && kp < S && keep(mode, qp, kp))) p = 0.f;
      }
      s[i] = p * (dp[i] - dl[rsel(i)]);  // dS
    }
    uint32_t a[4][4];
    to_a(s, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c)
        wgmma_rs(acc[c], a[kk], desc_mnmajor<ROWS>(kt, c, kk));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) fence_regs(acc[c]);
  }
  store_tile<D, Sh::NCH>(dq, sdq, b, h, q0, S, acc, scale);
}

// ---------------------------------------------------------------------------
// dK, dV: a block per key tile, query tiles of BQ rows streamed.
// Grid (ceil(S/64), H, B).
// ---------------------------------------------------------------------------

template <int D>
struct DkvShape {
  // At D = 128 the dK and dV sums take 128 registers a thread: a query
  // tile of 32 halves S^T and dP^T so nothing spills.
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int TK = Shape<D>::NCH * ROWS * CH;  // owned key tile
  static constexpr int TQ = Shape<D>::NCH * BQ * CH;    // streamed tile
  static constexpr size_t bytes =
      (2 * TK + 4 * TQ) * sizeof(bf16) + 4 * BQ * sizeof(float) + 3 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, Str sdk, Str sdv, int S, int H, float scale,
    int mode) {
  using Sh = Shape<D>;
  using Dk = DkvShape<D>;
  constexpr int BQ = Dk::BQ, TK = Dk::TK, TQ = Dk::TQ;
  constexpr int NQ = BQ / 2;  // accumulator floats of an m64nBQ tile
  bf16* ks = reinterpret_cast<bf16*>(smem_base());
  bf16* vs = ks + TK;
  bf16* qs = vs + TK;        // [2 stages][TQ]
  bf16* dos = qs + 2 * TQ;   // [2 stages][TQ]
  float* ls = reinterpret_cast<float*>(dos + 2 * TQ);  // [2][BQ] lse*log2e
  float* dls = ls + 2 * BQ;                            // [2][BQ] delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + 2 * BQ);  // kv, q0, q1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
  // The query tiles whose keys reach this key tile: from the first one on.
  const int n_q = (S + BQ - 1) / BQ;
  int first = 0;
  while (first < n_q && k0 >= key_end(mode, min((first + 1) * BQ, S) - 1, S))
    ++first;
  const int n_it = n_q - first;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_q = [&](int it) {
    const int st = it & 1, q0 = (first + it) * BQ;
    uint64_t* bar = &bars[1 + st];
    mbar_expect(bar, 2 * TQ * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) {
      tma_load(qs + st * TQ + c * BQ * CH, &tq, bar, c * CH, h, q0, b);
      tma_load(dos + st * TQ + c * BQ * CH, &tdo, bar, c * CH, h, q0, b);
    }
  };
  // Thread t < BQ carries lse of query q0 + t, thread 64 + t its delta.
  auto row_value = [&](int it) {
    const int t = tid & 63, r = (first + it) * BQ + t;
    if (t >= BQ || r >= S) return 0.f;
    return tid < 64 ? lse[row_base + r] * LOG2E : delta[row_base + r];
  };
  auto put_row = [&](int it, float x) {
    const int t = tid & 63;
    if (t < BQ) (tid < 64 ? ls : dls)[(it & 1) * BQ + t] = x;
  };
  if (tid == 0) {
    mbar_expect(&bars[0], 2 * TK * sizeof(bf16));
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) {
      tma_load(ks + c * ROWS * CH, &tk, &bars[0], c * CH, h, k0, b);
      tma_load(vs + c * ROWS * CH, &tv, &bars[0], c * CH, h, k0, b);
    }
    if (n_it > 0) load_q(0);
  }
  if (n_it > 0) put_row(0, row_value(0));
  const float sl2 = scale * LOG2E;
  const int r_lo = warp * 16 + lane / 4;
  float gk[Sh::NCH][32], gv[Sh::NCH][32];
#pragma unroll
  for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[c][i] = gv[c][i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, q0 = (first + it) * BQ;
    const bf16* qt = qs + st * TQ;
    const bf16* dot = dos + st * TQ;
    // Every thread is done with the other stage, and this stage's lse /
    // delta rows are in shared memory.
    __syncthreads();
    float next = 0.f;
    if (it + 1 < n_it) {
      if (tid == 0) load_q(it + 1);
      next = row_value(it + 1);
    }
    mbar_wait(&bars[1 + st], (it >> 1) & 1);

    float s[NQ], dp[NQ];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk)
      wgmma_ss(s, desc_kmajor<ROWS>(ks, kk), desc_kmajor<BQ>(qt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < Sh::KS; ++kk)
      wgmma_ss(dp, desc_kmajor<ROWS>(vs, kk), desc_kmajor<BQ>(dot, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = (mode != MASK_NONE && q0 <= k0 + ROWS - 1)
                        || q0 + BQ > S || k0 + ROWS > S;
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int c = col(i, lane);
      float p = exp2f(fmaf(s[i], sl2, -lt[c]));
      if (masked) {
        const int kp = k0 + r_lo + 8 * rsel(i), qp = q0 + c;
        if (!(qp < S && kp < S && keep(mode, qp, kp))) p = 0.f;
      }
      s[i] = p;                   // P^T
      dp[i] = p * (dp[i] - dt[c]);  // dS^T
    }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    to_a(s, pa);
    to_a(dp, sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c) {
        wgmma_rs(gv[c], pa[kk], desc_mnmajor<BQ>(dot, c, kk));
        wgmma_rs(gk[c], sa[kk], desc_mnmajor<BQ>(qt, c, kk));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c) {
      fence_regs(gk[c]);
      fence_regs(gv[c]);
    }
    if (it + 1 < n_it) put_row(it + 1, next);
  }
  store_tile<D, Sh::NCH>(dk, sdk, b, h, k0, S, gk, scale);
  store_tile<D, Sh::NCH>(dv, sdv, b, h, k0, S, gv, 1.f);
}

// ---------------------------------------------------------------------------
// Host side: launches
// ---------------------------------------------------------------------------

template <int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, const long long* st, int B, int S, int H,
                      float scale, int mode, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, st, B, S, H, D, ROWS)
      || !make_map(&mk, k, st + 3, B, S, H, D, ROWS)
      || !make_map(&mv, v, st + 6, B, S, H, D, ROWS)
      || !make_map(&mdo, dO, st + 9, B, S, H, D, ROWS))
    return cudaErrorInvalidValue;
  const size_t smem = DqSmem<D>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(dq_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dq_kernel<D><<<grid(B, S, H), NT, smem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), str(st, 4), S, H,
      scale, mode);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* st, int B, int S,
                       int H, float scale, int mode, cudaStream_t stream) {
  constexpr int BQ = DkvShape<D>::BQ;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, st, B, S, H, D, BQ)
      || !make_map(&mk, k, st + 3, B, S, H, D, ROWS)
      || !make_map(&mv, v, st + 6, B, S, H, D, ROWS)
      || !make_map(&mdo, dO, st + 9, B, S, H, D, BQ))
    return cudaErrorInvalidValue;
  const size_t smem = DkvShape<D>::bytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(dkv_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dkv_kernel<D><<<grid(B, S, H), NT, smem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), str(st, 4), str(st, 5), S, H, scale, mode);
  return cudaGetLastError();
}

}  // namespace

// Called by hvd_flash_bwd_dq / hvd_flash_bwd_dkv (flash_attention.cu) for
// bf16 operands, with their arguments already checked: `strides` holds
// 3 element strides (b, s, h) per [B, S, H, D] operand in the C
// interface's order (q, k, v, dO, then the outputs).  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue if a tensor map cannot
// be encoded.

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
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

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
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
