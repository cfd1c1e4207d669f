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
// (flash_attention.cu) when every operand is bf16; the f32 instances stay
// the SIMT kernels there, whose f32 products hold the JAX f32 gradient
// tolerance (TF32 would not).
//
// Contract (the SIMT kernels' own): q, k, v, dO and the outputs are
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
// end, never to a bf16 tile.  The one rounding this adds to the f32 SIMT
// kernels: P and dS enter the second products as bf16.
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
// block_contributes, as in the SIMT kernels), and the mask is applied
// element by element only on tiles the diagonal crosses or the sequence
// end cuts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MASK_NONE = 0;
constexpr int MASK_CAUSAL = 1;
constexpr int ROWS = 64;   // rows of the owned tile: one warpgroup's wgmma M
constexpr int NT = 128;    // one warpgroup
constexpr int CH = 64;     // bf16 columns in one 128-byte swizzled chunk
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Str {
  long long b, s, h;
};

__device__ __forceinline__ size_t at(const Str& st, int b, int s, int h) {
  return static_cast<size_t>(b) * st.b + static_cast<size_t>(s) * st.s
         + static_cast<size_t>(h) * st.h;
}

__device__ __forceinline__ bool keep(int mode, int qp, int kp) {
  return mode == MASK_NONE || (mode == MASK_CAUSAL ? qp >= kp : qp > kp);
}

// Keys a query tile ending at q_hi may see, exclusive (block_contributes).
__device__ __forceinline__ int key_end(int mode, int q_hi, int S) {
  if (mode == MASK_CAUSAL) return min(S, q_hi + 1);
  if (mode != MASK_NONE) return min(S, q_hi);  // STRICT
  return S;
}

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive once and expect `bytes` from TMA copies on this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A copy that never lands (a bad tensor map) traps after ~2^26 polls
// rather than hanging the card: the launch then fails where it ran.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One box (64 head-dim columns x rows x 1 x 1) at (d0, h, s0, b).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(h), "r"(s0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its asm names the registers only at issue).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// `lbo` and `sbo` in bytes; the chunk base is 1024-byte aligned, so the
// base-offset field stays 0.
__device__ __forceinline__ uint64_t sdesc(const bf16* p, uint32_t lbo,
                                          uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A tile is [rows][64k + c] bf16 stored as chunks of [rows][64], each
// rows * 128 bytes, rows at 128 bytes, 8-row swizzle atoms at 1024.
// K-major operand (the contraction runs along the head dim): k-step kk
// of 16 columns.
template <int RowsT>
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile, int kk) {
  return sdesc(tile + (kk / 4) * RowsT * CH + (kk % 4) * 16, 16, 1024);
}
// MN-major operand (the contraction runs along the tile's rows, the
// head-dim chunk `c` is wgmma's N): k-step kk of 16 rows.
template <int RowsT>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile, int c,
                                                 int kk) {
  return sdesc(tile + c * RowsT * CH + kk * 16 * CH, RowsT * CH * 2, 1024);
}

#define HVD_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HVD_F16(i) HVD_F4(i), HVD_F4(i + 4), HVD_F4(i + 8), HVD_F4(i + 12)

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVD_F16(0), HVD_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HVD_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs in
// the accumulator's layout), B MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HVD_F16(0), HVD_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HVD_F16
#undef HVD_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator element i of an m64nN tile held by lane `lane` of warp
// `warp`: row warp*16 + lane/4 + 8*rsel(i), column col(i, lane).
__device__ __forceinline__ int rsel(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// P or dS (an m64nN accumulator) as N/16 register A operands of 16 columns.
template <int R>
__device__ __forceinline__ void to_a(const float (&x)[R],
                                     uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Store rows [r0, r0 + 64) of a [64 x DP] f32 accumulator (times `mul`) as
// bf16, rows below S and columns below D only.
template <int D, int NCH>
__device__ __forceinline__ void store_tile(bf16* out, const Str& st, int b,
                                           int h, int r0, int S,
                                           float (&acc)[NCH][32], float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = r0 + warp * 16 + lane / 4 + 8 * rsel(i);
      const int cc = c * CH + col(i, lane);
      if (r < S && cc < D)
        *reinterpret_cast<__nv_bfloat162*>(out + at(st, b, r, h) + cc) =
            __floats2bfloat162_rn(acc[c][i] * mul, acc[c][i + 1] * mul);
    }
}

// Dynamic shared memory rounded up to the 1024 bytes a swizzle atom needs.
__device__ __forceinline__ char* smem_base() {
  extern __shared__ char raw[];
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return raw + pad;
}

template <int D>
struct Shape {
  static constexpr int DP = D < CH ? CH : D;  // stored columns
  static constexpr int NCH = DP / CH;         // 128-byte chunks per row
  static constexpr int KS = D / 16;           // k-steps along the head dim
};

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
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, H, S, B) over one bf16 [B, S, H, D] operand with element
// strides `st`, boxes of 64 head-dim columns x `rows` positions, 128-byte
// swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* base, const long long* st, int B,
              int S, int H, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {CH, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, std::atomic<unsigned>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

Str str(const long long* s, int i) {
  return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

dim3 grid(int B, int S, int H) { return dim3((S + ROWS - 1) / ROWS, H, B); }

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
