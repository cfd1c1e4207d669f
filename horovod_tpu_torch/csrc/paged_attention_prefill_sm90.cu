// Paged attention, prefill route (a chunk of C > 1 query rows per
// sequence), for NVIDIA Hopper (sm_90a), written by hand, on the tensor
// cores in split-precision TF32.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (horovod_tpu/serve/paged_attention.py:156, launched by `_paged_call`
// :236 through `pl.pallas_call` :274) where it runs with C > 1:
// `paged_prefill_attention` :309, every prefill chunk of the serving
// path.  The decode route (paged_attention_decode_sm90.cu) keeps C = 1.
// It computes attention of q [B, C, H, Dh] against one layer's K/V block
// pool [NB, BT, H, Dh] through the block tables [B, MB]:
//   * a table entry outside [0, NB) (NB is the hole sentinel) is never a
//     key and is never loaded, in every mask mode; a key block wholly
//     past the query tile's last row (causal: first key > last position;
//     strict: >=) is skipped the same way (`block_contributes`);
//   * the mask is on absolute positions: key j*BT + col against the
//     query at positions[b] + row (MASK_NONE / MASK_CAUSAL / MASK_STRICT);
//   * int8 and fp8 (e4m3fn) pools carry f16 scale rows [NB, BT, H]; f32
//     and bf16 pools are read as they are;
//   * scores and the online softmax are f32, q is prescaled, the running
//     max is floored at NEG_INF/2 and the sum at 1e-30, so a row that
//     sees no key is exactly 0; the output is f32.
//
// Bound.  A chunk does 4*Dh flops per (query, key) pair and reads each
// live K/V byte once: gpt2-small's serving chunk (B=4, C=64, H=12, Dh=64,
// BT=16, f32 pool, contexts up to 1024) moves 12.5 MB (3.7 us at 3.35
// TB/s) and needs 0.32 GFLOP, 4.8 us on the f32 FMA pipe (67 TFLOP/s) but
// 2.0 us as three TF32 passes on the tensor cores (495 TFLOP/s): on the
// tensor cores the route is bound by bytes.
//
// Numerics.  A single TF32 product rounds each operand to 11 significant
// bits (2^-11), which breaks the paged tolerance of 2e-4 / 2e-5.  So every
// f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi) and each
// product is hi*hi + hi*lo + lo*hi accumulated in f32 by the tensor core
// (CUTLASS's "fast f32"): the dropped lo*lo and the rounding of the lo
// parts leave about 3 * 2^-22 of |a||b|.  bf16, int8 and fp8 values are
// TF32 values already (lo = 0), so their products take two passes.  The
// bound of this route, carried through exp and the normalisation, is
// `paged_prefill_rounding_bound` (serve/paged_attention.py), derived in
// PERF.md.
//
// Design.  One thread block of W = 8 warps per (split of split_blocks
// table entries, head h, tile of QT = 64 query rows, sequence b); the
// split count depends on the table width only, so a row's arithmetic never
// depends on its batch.
//   * A key tile is `ent` = min(split_blocks, KT / BT) whole table entries,
//     fixed by table index: tile tau of a split holds entries tau*ent ..
//     tau*ent + ent - 1.  One ballot over the split's entries drops holes
//     and skipped blocks before anything is read; a tile with no live
//     entry is never loaded or folded, and a dead entry inside a live
//     tile is zero-filled and masked.  Skipping only cuts blocks wholly
//     past the query tile, a suffix of the table, so a row folds at the
//     same points at every chunk length (bucket) and its bits do not move.
//   * The warps form two groups of four.  Group gr folds the tiles tau
//     with tau % 2 == gr, each into its own online-softmax state; the two
//     states are combined in group order at the end.  The serving chunk's
//     split (BT = 16: two tiles of 64 keys) so folds both tiles at once,
//     and the first load is the only wait.
//   * In a group each warp owns 16 query rows and runs `mma.sync.m16n8k8`
//     TF32: S = (q*scale)*K^T for a tile is 8 n-tiles of 8 keys in
//     registers, so the online softmax needs only quad shuffles and no
//     exchange between warps.  P.V reads P straight from S's accumulator
//     registers: the k index of P.V is permuted (lane t holds keys 2t and
//     2t+1 of each 8), and V's fragment is read in the same order, so no
//     shuffle is needed.  The hi/lo split rounds with two integer
//     operations, as cvt.rna.tf32.f32 would (mma_sync.cuh, shared with
//     the f32 flash backward pair).
//   * Tiles are gathered through the table by 16-byte `cp.async.cg`
//     copies into one shared-memory stage per group (rows padded by 16
//     bytes, so fragment reads hit distinct banks), both tiles of a round
//     in flight at once.  Quantized pools stay narrow in shared memory and
//     are widened at fragment load; a key's scale multiplies its score,
//     and its V scale its probability.
//   * A table of S > 1 splits writes each split's partial (max, sum, and
//     the accumulator of rows that saw a key), and a second kernel merges
//     them in split order; it is launched as a programmatic dependent of
//     the first and waits for its writes inside, so no launch gap falls
//     between them.  (A thread-block cluster merging through distributed
//     shared memory measured slower: its blocks, empty splits included,
//     hold the card until the slowest split ends.)  No atomics: every sum
//     runs in an order fixed by the table.
//   * What bounds it: at the serving chunk the products, three
//     `mma.sync` TF32 passes, take about as long as the loads and the
//     merge together; `mma.sync` TF32 runs well below the card's dense
//     TF32 rate (wgmma's), so the byte bound is far off.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_STRICT = 2;
constexpr int GW = 4;                 // warps of a group: 16 query rows each
constexpr int NT = 2 * 32 * GW;       // two groups of warps per block
constexpr int QT = 16 * GW;           // query rows per block
constexpr int KT = 64;                // keys of one tile, at most
constexpr int MAX_BT = 64;            // largest block_tokens taken
constexpr int MAX_SPLIT_BLOCKS = 32;  // one table entry per lane
static_assert(NT == 4 * KT, "one thread per key column of both stages, "
              "two K or V scales each");

enum QKind { Q_F32 = 0, Q_BF16 = 1 };
enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2, KV_FP8 = 3 };

// Storage element of a pool kind and one of them widened to f32.  Every
// narrow kind widens to a TF32 value (at most 11 significant bits).
template <int KV> struct Kv;
template <> struct Kv<KV_F32> {
  using T = float;
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return *reinterpret_cast<const float*>(p);
  }
};
template <> struct Kv<KV_BF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
};
template <> struct Kv<KV_INT8> {
  using T = int8_t;
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
  }
};
template <> struct Kv<KV_FP8> {
  using T = uint8_t;  // float8_e4m3fn bits; every value is exact in f16
  static __device__ __forceinline__ float load(const uint8_t* p) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(*p, __NV_E4M3)));
  }
};

inline int num_splits(int mb, int split_blocks) {
  return mb > split_blocks ? (mb + split_blocks - 1) / split_blocks : 1;
}

__device__ __forceinline__ bool keep(int mode, int qpos, int kpos) {
  return kpos >= 0 && (mode == MASK_CAUSAL   ? kpos <= qpos
                       : mode == MASK_STRICT ? kpos < qpos
                                             : true);
}

// The bytes of one block's dynamic shared memory: the scaled q tile, one
// K/V stage per group, and per stage the keys' positions and (quantized)
// scales; then each key column's (entry, row) of a tile.  After the last
// round the stages hold group 1's softmax states.
template <int KV, int DH>
__host__ __device__ constexpr int stage_row() {
  return DH * static_cast<int>(sizeof(typename Kv<KV>::T)) + 16;
}
template <int KV, int DH>
__host__ __device__ constexpr int smem_bytes() {
  return QT * (DH + 4) * 4 + 2 * 2 * KT * stage_row<KV, DH>()
         + 2 * KT * 4 * 3 + KT * 4;
}

// A table of S > 1 splits writes each split's partial per row: part_ml
// [rows][S][2] (max, sum) and, for a row whose sum is not 0, part_acc
// [rows][S][DH], a row being (b * C + c) * H + h, for merge_splits_kernel.
template <int QK, int KV, int DH>
__global__ void __launch_bounds__(NT, DH <= 64 ? 2 : 1) paged_prefill_kernel(
    const void* __restrict__ q_, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const __half* __restrict__ k_scale,
    const __half* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int C, int H,
    int NB, int BT, int MB, int S, int split_blocks, int ent, float scale,
    int mask_mode) {
  constexpr bool kQuantized = KV == KV_INT8 || KV == KV_FP8;
  constexpr bool kExact = KV != KV_F32;
  constexpr int ESZ = static_cast<int>(sizeof(typename Kv<KV>::T));
  constexpr int ROWB = DH * ESZ;          // bytes of a key's head slice
  constexpr int RS = stage_row<KV, DH>();  // its padded row in a stage
  constexpr int CPR = ROWB / 16;          // 16-byte copies per key
  constexpr int QS = DH + 4;              // floats of a padded q row
  constexpr int NKD = DH / 8;             // k-steps of Q.K^T, n-tiles of P.V
  static_assert(ROWB % 16 == 0 && NT % CPR == 0, "whole 16-byte copies");

  // The merge pass may be launched now; it waits for this grid's writes.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int h = blockIdx.y % H;
  const int q0 = (blockIdx.y / H) * QT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = warp / GW;  // this warp's group
  const int g = lane >> 2;   // fragment row (and B column)
  const int t4 = lane & 3;   // fragment column pair
  const int rows = min(QT, C - q0);
  const int q_lo = positions[b] + q0;
  const int q_hi = q_lo + rows - 1;
  const int j0 = split * split_blocks;
  const int n_ent = max(0, min(split_blocks, MB - j0));
  const int n_tiles = (n_ent + ent - 1) / ent;

  // q's loads go out with the table's; q lands in shared memory once the
  // first tiles are in flight.
  constexpr int QE = QT * DH / NT;  // q elements a thread
  float qx[QE];
#pragma unroll
  for (int u = 0; u < QE; ++u) {
    const int r = (u * NT + tid) / DH;
    const size_t off = ((static_cast<size_t>(b) * C + q0 + r) * H + h) * DH
                       + (u * NT + tid) % DH;
    qx[u] = r >= rows ? 0.f
            : QK == Q_F32
                ? static_cast<const float*>(q_)[off]
                : __uint_as_float(static_cast<uint32_t>(
                      static_cast<const uint16_t*>(q_)[off]) << 16);
  }

  // One table entry per lane; one ballot names the split's live entries,
  // the same in every warp.
  int t_lane = 0;
  bool live_e = false;
  if (lane < n_ent) {
    t_lane = tables[static_cast<size_t>(b) * MB + j0 + lane];
    const int k_lo = (j0 + lane) * BT;
    live_e = t_lane >= 0 && t_lane < NB;
    if (mask_mode == MASK_CAUSAL) live_e = live_e && k_lo <= q_hi;
    if (mask_mode == MASK_STRICT) live_e = live_e && k_lo < q_hi;
  }
  const unsigned live = __ballot_sync(0xffffffffu, live_e);
  const unsigned emask = ent >= 32 ? 0xffffffffu : (1u << ent) - 1u;
  unsigned tiles = 0;  // live key tiles of the split
  for (int tau = 0; tau < n_tiles; ++tau)
    if ((live >> (tau * ent)) & emask) tiles |= 1u << tau;

  if (tiles == 0) {  // no key for any row: 0, or a weightless partial
    for (int row = tid; row < rows; row += NT) {
      const size_t r = (static_cast<size_t>(b) * C + q0 + row) * H + h;
      if (S == 1) {
        for (int d = 0; d < DH; ++d) out[r * DH + d] = 0.f;
      } else {
        part_ml[(r * S + split) * 2] = NEG_INF;
        part_ml[(r * S + split) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);           // [QT][QS]
  uint8_t* stages = smem + QT * QS * 4;                   // [2][K|V][KT][RS]
  int* kpos_s = reinterpret_cast<int*>(stages + 2 * 2 * KT * RS);  // [2][KT]
  float* ksc_s = reinterpret_cast<float*>(kpos_s + 2 * KT);        // [2][KT]
  float* vsc_s = ksc_s + 2 * KT;                                   // [2][KT]
  int* col_s = reinterpret_cast<int*>(vsc_s + 2 * KT);  // [KT] entry<<8|row

  if (tid < KT) col_s[tid] = (tid / BT) << 8 | tid % BT;
  __syncthreads();

  // Tile tau into stage st: K and V rows by cp.async, dead columns
  // zero-filled.
  auto issue = [&](int tau, int st) {
    uint8_t* ks = stages + st * 2 * KT * RS;
    uint8_t* vs = ks + KT * RS;
    const int e0 = tau * ent;
    const int cols = min(ent, n_ent - e0) * BT;
    const int total = ((cols + 7) & ~7) * CPR;
    const int piece = tid % CPR;  // the same in every trip
    for (int base = 0; base < total; base += NT) {  // warp-uniform trips
      const int c = (base + tid) / CPR;
      const int er = col_s[c & (KT - 1)];
      const int ent_i = min(e0 + (er >> 8), 31);
      const int t = __shfl_sync(0xffffffffu, t_lane, ent_i);
      const bool ok = c < cols && ((live >> ent_i) & 1u);
      const size_t off =
          ok ? ((static_cast<size_t>(t) * BT + (er & 0xff)) * H + h) * ROWB
                   + piece * 16
             : 0;
      if (base + tid < total) {
        cp_async16(ks + c * RS + piece * 16, kp + off, ok);
        cp_async16(vs + c * RS + piece * 16, vp + off, ok);
      }
    }
  };
  // The key positions (-1: no key) and scales of the round's two tiles.
  auto describe = [&](int tau0, unsigned pair) {
    if (tid < 2 * KT) {
      const int st = tid / KT;
      const int c = tid % KT;
      const int er = col_s[c];
      const int e0 = (tau0 + st) * ent;
      const int ent_i = min(e0 + (er >> 8), 31);
      const int t = __shfl_sync(0xffffffffu, t_lane, ent_i);
      const bool ok = ((pair >> st) & 1u) && (er >> 8) < ent
                      && e0 + (er >> 8) < n_ent && ((live >> ent_i) & 1u);
      kpos_s[st * KT + c] = ok ? (j0 + e0) * BT + c : -1;
      if (kQuantized) {
        const size_t at = (static_cast<size_t>(t) * BT + (er & 0xff)) * H + h;
        ksc_s[st * KT + c] = ok ? __half2float(k_scale[at]) : 0.f;
        vsc_s[st * KT + c] = ok ? __half2float(v_scale[at]) : 0.f;
      }
    }
  };

  // The first round's tiles go out before q lands in shared memory.
  int tau0 = __ffs(tiles) - 1 & ~1;
  unsigned pair = (tiles >> tau0) & 3u;
  if (pair & 1u) issue(tau0, 0);
  if (pair & 2u) issue(tau0 + 1, 1);
#pragma unroll
  for (int u = 0; u < QE; ++u)
    q_s[(u * NT + tid) / DH * QS + (u * NT + tid) % DH] = qx[u] * scale;

  // This lane's share of its warp's state: rows g and g + 8 of the warp's
  // 16, columns 2*t4, 2*t4 + 1 of each 8 of Dh.
  const int row0 = (warp % GW) * 16 + g;
  const int qpos0 = q_lo + row0;
  const bool has_rows = (warp % GW) * 16 < rows;  // warp-uniform
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  float oacc[NKD][4];
#pragma unroll
  for (int d = 0; d < NKD; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[d][i] = 0.f;

  // Rounds of two tiles, tau0 for group 0 and tau0 + 1 for group 1.
  while (true) {
    describe(tau0, pair);
    cp_async_wait_all();
    __syncthreads();  // both tiles (and, the first time, q) are in place
    const int cur = tau0 + gr;
    if (has_rows && ((pair >> gr) & 1u)) {
      const uint8_t* ks = stages + gr * 2 * KT * RS;
      const uint8_t* vs = ks + KT * RS;
      const int* kpos = kpos_s + gr * KT;
      const float* ksc = ksc_s + gr * KT;
      const float* vsc = vsc_s + gr * KT;
      const int ntl = (min(ent, n_ent - cur * ent) * BT + 7) >> 3;

      // S = (q * scale) . K^T: 16 rows x 8 n-tiles of 8 keys.
      float sacc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[n][i] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < NKD; ++kk) {
        uint32_t ahi[4], alo[4];
        const float* qa = q_s + row0 * QS + kk * 8 + t4;
        split_tf32(qa[0], ahi[0], alo[0]);            // (g,     t4)
        split_tf32(qa[8 * QS], ahi[1], alo[1]);       // (g + 8, t4)
        split_tf32(qa[4], ahi[2], alo[2]);            // (g,     t4 + 4)
        split_tf32(qa[8 * QS + 4], ahi[3], alo[3]);   // (g + 8, t4 + 4)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n < ntl) {
            const uint8_t* kr = ks + (n * 8 + g) * RS + (kk * 8 + t4) * ESZ;
            mma3<kExact>(sacc[n], ahi, alo,
                         split_b<kExact>(Kv<KV>::load(kr),
                                         Kv<KV>::load(kr + 4 * ESZ)));
          }
        }
      }

      // Scale, mask, and the online softmax of rows g and g + 8.
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < ntl) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n * 8 + 2 * t4 + (i & 1);
            float s = sacc[n][i];
            if (kQuantized) s *= ksc[c];
            s = keep(mask_mode, qpos0 + (i >> 1) * 8, kpos[c]) ? s : NEG_INF;
            sacc[n][i] = s;
            mx[i >> 1] = fmaxf(mx[i >> 1], s);
          }
        }
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(fmaxf(m_r[r], mx[r]), NEG_INF * 0.5f);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < ntl) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = expf(sacc[n][i] - m_new[i >> 1]);  // 0 if masked
            sum[i >> 1] += p;
            sacc[n][i] = kQuantized ? p * vsc[n * 8 + 2 * t4 + (i & 1)] : p;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        const float corr = expf(m_r[r] - m_new[r]);
        m_r[r] = m_new[r];
        l_r[r] = l_r[r] * corr + sum[r];
#pragma unroll
        for (int d = 0; d < NKD; ++d) {
          oacc[d][2 * r] *= corr;
          oacc[d][2 * r + 1] *= corr;
        }
      }

      // O += P . V.  P's k index j*8 + i stands for key j*8 + key(i) with
      // key(t4) = 2*t4 and key(t4 + 4) = 2*t4 + 1: lane (g, t4) already
      // holds those probabilities in sacc[j], and reads V rows 2*t4 and
      // 2*t4 + 1 for its B fragment.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < ntl) {
          uint32_t ahi[4], alo[4];
          split_tf32(sacc[j][0], ahi[0], alo[0]);  // (g,     key 2*t4)
          split_tf32(sacc[j][2], ahi[1], alo[1]);  // (g + 8, key 2*t4)
          split_tf32(sacc[j][1], ahi[2], alo[2]);  // (g,     key 2*t4 + 1)
          split_tf32(sacc[j][3], ahi[3], alo[3]);  // (g + 8, key 2*t4 + 1)
          const uint8_t* v0 = vs + (j * 8 + 2 * t4) * RS + g * ESZ;
#pragma unroll
          for (int d = 0; d < NKD; ++d)
            mma3<kExact>(oacc[d], ahi, alo,
                         split_b<kExact>(Kv<KV>::load(v0 + d * 8 * ESZ),
                                         Kv<KV>::load(v0 + RS + d * 8 * ESZ)));
        }
      }
    }
    __syncthreads();  // both stages are free again
    const unsigned later = tau0 + 2 < 32 ? tiles >> (tau0 + 2) : 0u;
    if (later == 0) break;
    tau0 += 2 + ((__ffs(later) - 1) & ~1);
    pair = (tiles >> tau0) & 3u;
    if (pair & 1u) issue(tau0, 0);
    if (pair & 2u) issue(tau0 + 1, 1);
  }

  // Group 1 hands its states to group 0 through the idle stages; group 0
  // combines them in group order: the larger max, each side rescaled.
  float* st_ml = reinterpret_cast<float*>(stages);  // [QT][2]
  float* st_acc = st_ml + 2 * QT;                   // [QT][DH]
  if (gr == 1 && has_rows) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
#pragma unroll
      for (int d = 0; d < NKD; ++d)
        *reinterpret_cast<float2*>(st_acc + row * DH + d * 8 + 2 * t4) =
            make_float2(oacc[d][2 * r], oacc[d][2 * r + 1]);
      if (t4 == 0) {
        st_ml[row * 2] = m_r[r];
        st_ml[row * 2 + 1] = l_r[r];
      }
    }
  }
  __syncthreads();
  if (gr == 1 || !has_rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const float m1 = st_ml[row * 2];
    const float m = fmaxf(m_r[r], m1);
    const float f0 = expf(m_r[r] - m);
    const float f1 = expf(m1 - m);
    const float l = f0 * l_r[r] + f1 * st_ml[row * 2 + 1];
    const size_t at = (static_cast<size_t>(b) * C + q0 + row) * H + h;
    float o[NKD][2];
#pragma unroll
    for (int d = 0; d < NKD; ++d) {
      const float2 a1 = *reinterpret_cast<const float2*>(
          st_acc + row * DH + d * 8 + 2 * t4);
      o[d][0] = f0 * oacc[d][2 * r] + f1 * a1.x;
      o[d][1] = f0 * oacc[d][2 * r + 1] + f1 * a1.y;
    }
    if (S == 1) {  // the block's state is the row's result
      float* dst = out + at * DH + 2 * t4;
      const float lf = fmaxf(l, 1e-30f);
#pragma unroll
      for (int d = 0; d < NKD; ++d)
        *reinterpret_cast<float2*>(dst + d * 8) =
            make_float2(o[d][0] / lf, o[d][1] / lf);
    } else {  // a partial for the merge pass
      const size_t slot = at * S + split;
      if (l != 0.f) {
        float* dst = part_acc + slot * DH + 2 * t4;
#pragma unroll
        for (int d = 0; d < NKD; ++d)
          *reinterpret_cast<float2*>(dst + d * 8) =
              make_float2(o[d][0], o[d][1]);
      }
      if (t4 == 0) {
        part_ml[slot * 2] = m;
        part_ml[slot * 2 + 1] = l;
      }
    }
  }
}

// Merge the S splits of each query row, in split order: one warp per row,
// lane i holding split s0 + i's (max, sum) for each 32 splits from s0.  A
// split whose sum is 0 saw no key for the row and weighs nothing (its
// accumulator was not written); a row no split saw comes out exactly 0.
template <int DH>
__global__ void __launch_bounds__(128) merge_splits_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    float* __restrict__ out, int n_rows, int S) {
  constexpr int PER_LANE = DH < 32 ? 1 : DH / 32;
  // Launched as a programmatic dependent of the prefill grid: wait until
  // every one of its partials is written.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* ml = part_ml + static_cast<size_t>(row) * S * 2;
  const float* pa = part_acc + static_cast<size_t>(row) * S * DH;
  float m = NEG_INF;
  for (int s0 = lane; s0 < S; s0 += 32) m = fmaxf(m, ml[s0 * 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, o[PER_LANE] = {};
  for (int s0 = 0; s0 < S; s0 += 32) {
    const bool mine = s0 + lane < S;
    const float ls = mine ? ml[(s0 + lane) * 2 + 1] : 0.f;
    const float fs = mine ? expf(ml[(s0 + lane) * 2] - m) : 0.f;
    unsigned seen = __ballot_sync(0xffffffffu, ls != 0.f);
    while (seen) {  // the splits that saw a key, in order
      const int i = __ffs(seen) - 1;
      seen &= seen - 1;
      const float f = __shfl_sync(0xffffffffu, fs, i);
      l += f * __shfl_sync(0xffffffffu, ls, i);
      const float* a = pa + static_cast<size_t>(s0 + i) * DH + lane;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k)
        if (k * 32 + lane < DH) o[k] += f * a[k * 32];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k)
    if (k * 32 + lane < DH)
      out[static_cast<size_t>(row) * DH + k * 32 + lane] =
          o[k] / fmaxf(l, 1e-30f);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* tables;
  const void* positions;
  void* out;
  void* scratch;
  int B, C, H, NB, BT, MB, split_blocks;
  float scale;
  int mask_mode;
  cudaStream_t stream;
};

template <int QK, int KV, int DH>
cudaError_t launch(const Args& a) {
  constexpr int smem = smem_bytes<KV, DH>();
  // Set once per instance (C++ makes the initialisation thread-safe).
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_prefill_kernel<QK, KV, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int S = num_splits(a.MB, a.split_blocks);
  const int fit = KT / a.BT;  // whole blocks in a key tile, at most a split
  const int ent = fit < 1 ? 1 : fit < a.split_blocks ? fit : a.split_blocks;
  const int q_tiles = (a.C + QT - 1) / QT;
  const size_t n_rows = static_cast<size_t>(a.B) * a.C * a.H;
  float* part_ml = S > 1 ? static_cast<float*>(a.scratch) : nullptr;
  float* part_acc = S > 1 ? part_ml + n_rows * S * 2 : nullptr;
  paged_prefill_kernel<QK, KV, DH>
      <<<dim3(S, a.H * q_tiles, a.B), NT, smem, a.stream>>>(
          a.q, static_cast<const uint8_t*>(a.k),
          static_cast<const uint8_t*>(a.v),
          static_cast<const __half*>(a.k_scale),
          static_cast<const __half*>(a.v_scale),
          static_cast<const int*>(a.tables),
          static_cast<const int*>(a.positions), static_cast<float*>(a.out),
          part_ml, part_acc, a.C, a.H, a.NB, a.BT, a.MB, S, a.split_blocks,
          ent, a.scale, a.mask_mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  // The merge pass launches while the prefill grid runs (programmatic
  // dependent launch) and waits for it inside, so no launch gap falls
  // between the two.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n_rows + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.stream = a.stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, merge_splits_kernel<DH>,
                         static_cast<const float*>(part_ml),
                         static_cast<const float*>(part_acc),
                         static_cast<float*>(a.out), static_cast<int>(n_rows),
                         S);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

template <int QK, int KV>
cudaError_t by_head_dim(const Args& a, int Dh) {
  switch (Dh) {
    case 16: return launch<QK, KV, 16>(a);
    case 32: return launch<QK, KV, 32>(a);
    case 64: return launch<QK, KV, 64>(a);
    case 128: return launch<QK, KV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int QK>
cudaError_t by_pool(const Args& a, int Dh, int kv_kind) {
  switch (kv_kind) {
    case KV_F32: return by_head_dim<QK, KV_F32>(a, Dh);
    case KV_BF16: return by_head_dim<QK, KV_BF16>(a, Dh);
    case KV_INT8: return by_head_dim<QK, KV_INT8>(a, Dh);
    case KV_FP8: return by_head_dim<QK, KV_FP8>(a, Dh);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded through ctypes (horovod_tpu_torch/csrc/build.py),
// with the argument list of `hvd_paged_decode`; C >= 1 (the wrapper sends
// C > 1 here).  Every pointer is a device pointer; the scale pointers are
// null for f32/bf16 pools.  The pools must be 16-byte aligned.  With
// S = ceil(MB / split_blocks) > 1, `scratch` holds B*C*H*S*(Dh + 2)
// floats; it is unused (may be null) otherwise.  Launches on `stream` and
// does not synchronise.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int hvd_paged_prefill(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* out, void* scratch, int B, int C, int H,
    int Dh, int NB, int BT, int MB, int split_blocks, float scale,
    int mask_mode, int q_kind, int kv_kind, void* stream) {
  if (C < 1 || BT < 1 || BT > MAX_BT || NB < 1 || MB < 0 || H < 1
      || split_blocks < 1 || split_blocks > MAX_SPLIT_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               scratch, B, C, H, NB, BT, MB, split_blocks, scale, mask_mode,
               static_cast<cudaStream_t>(stream)};
  switch (q_kind) {
    case Q_F32: return static_cast<int>(by_pool<Q_F32>(a, Dh, kv_kind));
    case Q_BF16: return static_cast<int>(by_pool<Q_BF16>(a, Dh, kv_kind));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
