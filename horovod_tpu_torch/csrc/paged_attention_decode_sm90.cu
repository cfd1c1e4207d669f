// Paged attention, decode route (one query row per sequence), for NVIDIA
// Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (horovod_tpu/serve/paged_attention.py:156, launched by `_paged_call`
// :236) where it runs with C = 1: `paged_decode_attention` :287, and a
// one-row `paged_prefill_attention` :309; the prefill route
// (paged_attention_prefill_sm90.cu) takes every longer chunk.  It
// computes attention of q [B, 1, H, Dh] against one layer's K/V block
// pool [NB, BT, H, Dh] through the block tables [B, MB]:
//   * a table entry outside [0, NB) (NB is the hole sentinel) is never a
//     key and is never loaded, in every mask mode; a key block wholly
//     past the query (causal: first key > position; strict: >=) is
//     skipped the same way;
//   * the mask is on absolute positions: key j*BT + col against the
//     query at positions[b] (MASK_NONE / MASK_CAUSAL / MASK_STRICT);
//   * int8 and fp8 (e4m3fn) pools carry f16 scale rows [NB, BT, H]; f32
//     and bf16 pools are read as they are;
//   * scores and the online softmax are f32, q is prescaled, the running
//     max is floored at NEG_INF/2 and the sum at 1e-30, so a row that
//     sees no key is exactly 0; the output is f32.  Nothing is rounded
//     below f32.
//
// Bound.  A decode step is memory-bound: it reads each live K and V byte
// once and does 4*Dh flops per key, about one flop per byte at f32, far
// under the card's 20 flops per byte.  gpt2-small at B=8 with
// 1024-token contexts reads 8*12*1024*64*4*2 = 50.3 MB of f32 K/V per
// layer: 15.0 us at 3.35 TB/s.  By Little's law that rate needs about
// 3.35 TB/s * ~1 us of latency = ~3.4 MB in flight, ~25 KB per SM.
//
// Design.  One thread block of W = 4 warps per (sequence b, head h,
// split of split_blocks table entries); the split count depends on the
// table width only, as in the prefill route, so a row's arithmetic never
// depends on its batch.
//   * Each lane reads one table entry of the split, so one ballot gives
//     the split's contributing blocks.  An empty split (a short row's
//     later splits) has no tile and goes straight to the merge.
//   * The contributing blocks are cut into tiles of up to STAGE_BYTES of
//     K + V (4 keys at f32 Dh = 64, a whole BT = 16 block of int8).  Warp
//     w takes tiles w, w + W, ... and keeps its own ring of NST stages in
//     shared memory, fed by 16-byte `cp.async.cg` copies with
//     commit/wait groups: the next tile is in flight while one is folded,
//     and no `__syncthreads()` falls between score, softmax and P.V.  A
//     block needs at most 19 KB of shared memory and 56-92 registers a
//     thread, so the 768 blocks of gpt2-small's B=8 decode fit on the
//     card at once and their loads can all go out in one wave.  (Larger
//     stages, deeper rings and eight warps a block measured slower.)
//   * Quantized pools stay narrow in shared memory and are widened as
//     they are consumed (int8 through a byte permute and an exact f32
//     subtraction, fp8 two values to one conversion); their 2-byte
//     scales (stride H*2, too small for `cp.async`) are plain loads
//     issued with the tile's copies and read back through a shuffle when
//     the tile is folded.
//   * A key's head slice is Dh*size bytes; LPR = that / 16 lanes each
//     hold 16 bytes of it and 32 / LPR keys are scored per pass, so a
//     shuffle tree of log2(LPR) steps finishes a score.  The lane that
//     holds a key's score also holds that key's V bytes for its slice,
//     so P.V needs no exchange: each lane keeps (m, l, acc) for its keys
//     and its slice of Dh in registers, and the warp sums its lanes once
//     at the end.
//   * The S <= 8 splits of a row run as one thread-block cluster: each
//     warp leaves its (m, l, acc) in shared memory, and after a cluster
//     barrier the first split's block reads all S * W states through
//     distributed shared memory, in (split, warp) order, and writes the
//     row: no second launch and no partials in device memory.  A wider
//     table (S > 8) writes each split's partial, and a second kernel
//     merges them in split order, as the prefill route's pass does.
//     Every sum runs in an order fixed by the table, and there are no
//     atomics: a row gets the same bits alone as in a batch.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_STRICT = 2;
constexpr int W = 4;                 // warps per thread block
constexpr int NT = 32 * W;
constexpr int NST = 2;               // ring stages per warp
constexpr int STAGE_BYTES = 2048;    // K + V bytes of one stage, at most
constexpr int MAX_BT = 64;           // largest block_tokens taken
constexpr int MAX_SPLIT_BLOCKS = 32; // one table entry per lane
constexpr int MAX_CLUSTER = 8;       // splits merged inside one cluster
// The rings and the warps' states stay under the 48 KB a block gets
// without opting in, at every head dim.
static_assert(W * NST * STAGE_BYTES + W * (128 + 2) * 4 <= 48 * 1024,
              "shared memory of one block");

enum QKind { Q_F32 = 0, Q_BF16 = 1 };
enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2, KV_FP8 = 3 };

__device__ __forceinline__ float bf16_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// Storage element of a pool kind, and 16 of its bytes widened to f32.
template <int KV> struct Kv;
template <> struct Kv<KV_F32> {
  using T = float;
  static __device__ __forceinline__ void widen(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <> struct Kv<KV_BF16> {
  using T = uint16_t;
  static __device__ __forceinline__ void widen(uint4 r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Kv<KV_INT8> {
  using T = int8_t;
  // The bits 0x4b0000uu are the float 2^23 + uu; with uu = byte ^ 0x80 =
  // value + 128, subtracting 2^23 + 128 leaves the value, exactly.
  static __device__ __forceinline__ void widen(uint4 r, float* x) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = __uint_as_float(
                 __byte_perm(w[i / 4], 0x4b000000u, 0x7540u + i % 4))
             - 8388736.f;
  }
};
template <> struct Kv<KV_FP8> {
  using T = uint8_t;  // float8_e4m3fn bits; every value is exact in f16
  static __device__ __forceinline__ void widen(uint4 r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i / 2] >> (16 * (i % 2))),
          __NV_E4M3)));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// Keys of one tile at most: STAGE_BYTES of K + V, and no more than a
// block holds.
template <int KV, int DH>
__host__ __device__ constexpr int max_tile_rows() {
  constexpr int row = DH * static_cast<int>(sizeof(typename Kv<KV>::T));
  return STAGE_BYTES / (2 * row) < MAX_BT ? STAGE_BYTES / (2 * row) : MAX_BT;
}

inline int num_splits(int mb, int split_blocks) {
  return mb > split_blocks ? (mb + split_blocks - 1) / split_blocks : 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n partial states (max, sum, accumulator [DH] as state(i)[DH],
// state(i)[DH + 1], state(i)[0, DH)) folded in order i = 0, 1, ...:
// the largest max, then the sums rescaled to it.  Thread d takes
// dimension d of the accumulator.
struct Merged {
  float m, l, o;
};
template <int DH, typename State>
__device__ __forceinline__ Merged merge_states(int n, State state, int d) {
  Merged r{NEG_INF, 0.f, 0.f};
  for (int i = 0; i < n; ++i) r.m = fmaxf(r.m, state(i)[DH]);
  for (int i = 0; i < n; ++i) {
    const float* s = state(i);
    const float f = expf(s[DH] - r.m);
    r.l += f * s[DH + 1];
    r.o += f * s[d];
  }
  return r;
}

// Launched as clusters of S blocks along x when S <= MAX_CLUSTER (block
// rank = split).  Otherwise each split writes its partial per row:
// part_ml [rows][S][2] (max, sum) and part_acc [rows][S][DH], a row being
// b * H + h, for merge_splits_kernel.
template <int QK, int KV, int DH>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const void* __restrict__ q_, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ vp, const __half* __restrict__ k_scale,
    const __half* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
    int NB, int BT, int MB, int S, int split_blocks, int tile_rows,
    float scale, int mask_mode) {
  using KT = typename Kv<KV>::T;
  constexpr bool kQuantized = KV == KV_INT8 || KV == KV_FP8;
  constexpr int ROW = DH * static_cast<int>(sizeof(KT));  // bytes of a key
  constexpr int LPR = ROW / 16;     // lanes per key, 16 bytes each
  constexpr int KPP = 32 / LPR;     // keys per pass of the warp
  constexpr int VE = 16 / static_cast<int>(sizeof(KT));  // elements a lane
  constexpr int NPASS = max_tile_rows<KV, DH>() / KPP;
  static_assert(LPR >= 1 && LPR <= 32 && VE * LPR == DH, "lane layout");
  static_assert(NPASS >= 1, "a tile holds at least one pass");

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPR;      // which key of a pass
  const int chunk = lane % LPR;     // which 16 bytes of it
  const int qpos = positions[b];
  const int j0 = split * split_blocks;
  const size_t row_out = static_cast<size_t>(b) * H + h;

  // One table entry per lane; one ballot names the split's key blocks.
  int t_lane = 0;
  bool keys = false;
  if (lane < split_blocks && j0 + lane < MB) {
    t_lane = tables[static_cast<size_t>(b) * MB + j0 + lane];
    const int k_lo = (j0 + lane) * BT;
    keys = t_lane >= 0 && t_lane < NB;
    if (mask_mode == MASK_CAUSAL) keys = keys && k_lo <= qpos;
    if (mask_mode == MASK_STRICT) keys = keys && k_lo < qpos;
  }
  const unsigned live = __ballot_sync(0xffffffffu, keys);

  const int tiles_per_block = (BT + tile_rows - 1) / tile_rows;
  const int n_tiles = __popc(live) * tiles_per_block;
  const int mine = n_tiles > warp ? (n_tiles - warp + W - 1) / W : 0;
  const int stage_bytes = 2 * tile_rows * ROW;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + warp * NST * stage_bytes;
  float* comb = reinterpret_cast<float*>(smem + W * NST * stage_bytes);

  // Tile i of the split: the (i / tiles_per_block)-th key block, rows
  // from (i % tiles_per_block) * tile_rows.  Warp-uniform.
  struct Tile {
    size_t g0;  // key-row index (t * BT + r0) * H + h of its first row
    int k0;     // absolute position of its first key
    int rows;
  };
  auto tile_at = [&](int i) {
    unsigned m = live;
    for (int c = i / tiles_per_block; c > 0; --c) m &= m - 1;
    const int e = __ffs(m) - 1;
    const int t = __shfl_sync(0xffffffffu, t_lane, e);
    const int r0 = (i % tiles_per_block) * tile_rows;
    Tile tl;
    tl.g0 = (static_cast<size_t>(t) * BT + r0) * H + h;
    tl.k0 = (j0 + e) * BT + r0;
    tl.rows = min(tile_rows, BT - r0);
    return tl;
  };

  // Scale of rows lane and lane + 32 of each stage (quantized pools).
  __half ksc[NST][2], vsc[NST][2];
  auto issue = [&](int i, int s) {
    const Tile tl = tile_at(i);
    uint8_t* ks = ring + s * stage_bytes;
    uint8_t* vs = ks + tile_rows * ROW;
    for (int c = lane; c < tl.rows * LPR; c += 32) {
      const size_t off = (tl.g0 + static_cast<size_t>(c / LPR) * H) * ROW
                         + (c % LPR) * 16;
      cp_async16(ks + c * 16, kp + off);
      cp_async16(vs + c * 16, vp + off);
    }
    if (kQuantized) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u;
        if (r < tl.rows) {
          ksc[s][u] = k_scale[tl.g0 + static_cast<size_t>(r) * H];
          vsc[s][u] = v_scale[tl.g0 + static_cast<size_t>(r) * H];
        }
      }
    }
  };

  // The first NST tiles go out before q is read.
  const int tile0 = warp;  // this warp's tiles: warp + k * W
#pragma unroll
  for (int s = 0; s < NST; ++s) {
    if (s < mine) issue(tile0 + s * W, s);
    cp_async_commit();
  }

  float qr[VE];
  {
    const size_t off = row_out * DH + chunk * VE;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float x =
          QK == Q_F32
              ? static_cast<const float*>(q_)[off + e]
              : bf16_to_float(static_cast<const uint16_t*>(q_)[off + e]);
      qr[e] = x * scale;
    }
  }

  // This lane's share of the warp's state: its keys (slot), its slice of
  // Dh (chunk).  m is the same in every lane.
  float m = NEG_INF, l = 0.f, acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < mine; k0 += NST) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      const int k = k0 + s;
      if (k < mine) {
        cp_async_wait<NST - 1>();
        __syncwarp();
        const Tile tl = tile_at(tile0 + k * W);
        const uint8_t* ks = ring + s * stage_bytes;
        const uint8_t* vs = ks + tile_rows * ROW;
        float sc[NPASS];
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < NPASS; ++i) {
          sc[i] = NEG_INF;
          if (i * KPP < tl.rows) {  // warp-uniform
            const int r = slot + i * KPP;
            float part = 0.f;
            if (r < tl.rows) {
              float kx[VE];
              Kv<KV>::widen(
                  *reinterpret_cast<const uint4*>(ks + r * ROW + chunk * 16),
                  kx);
#pragma unroll
              for (int e = 0; e < VE; ++e) part = fmaf(qr[e], kx[e], part);
            }
#pragma unroll
            for (int o = LPR / 2; o > 0; o >>= 1)
              part += __shfl_xor_sync(0xffffffffu, part, o);
            if (kQuantized)
              part *= __shfl_sync(0xffffffffu,
                                  __half2float(ksc[s][(i * KPP) >> 5]),
                                  r & 31);
            const int kpos = tl.k0 + r;
            const bool keep =
                r < tl.rows
                && (mask_mode == MASK_CAUSAL   ? kpos <= qpos
                    : mask_mode == MASK_STRICT ? kpos < qpos
                                               : true);
            sc[i] = keep ? part : NEG_INF;
            mx = fmaxf(mx, sc[i]);
          }
        }
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(fmaxf(m, mx), NEG_INF * 0.5f);
        const float corr = expf(m - m_new);
        m = m_new;
        l *= corr;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] *= corr;
#pragma unroll
        for (int i = 0; i < NPASS; ++i) {
          if (i * KPP < tl.rows) {
            const int r = slot + i * KPP;
            float p = expf(sc[i] - m_new);  // 0 for a masked key
            l += p;
            if (kQuantized)
              p *= __shfl_sync(0xffffffffu,
                               __half2float(vsc[s][(i * KPP) >> 5]), r & 31);
            if (r < tl.rows) {
              float vx[VE];
              Kv<KV>::widen(
                  *reinterpret_cast<const uint4*>(vs + r * ROW + chunk * 16),
                  vx);
#pragma unroll
              for (int e = 0; e < VE; ++e) acc[e] = fmaf(p, vx[e], acc[e]);
            }
          }
        }
        __syncwarp();  // every lane is done with the stage
        if (k + NST < mine) issue(tile0 + (k + NST) * W, s);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();

  // The warp's keys: sum the slots (lanes that share a chunk).
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < VE; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  float* mine_state = comb + warp * (DH + 2);
  if (slot == 0) {
#pragma unroll
    for (int e = 0; e < VE; ++e) mine_state[chunk * VE + e] = acc[e];
    if (lane == 0) {
      mine_state[DH] = m;
      mine_state[DH + 1] = l;
    }
  }

  // States in (split, warp) order; a warp or split without a key carries
  // (NEG_INF, 0, 0) and weighs nothing; a row without one comes out 0.
  const int d = threadIdx.x;
  if (S <= MAX_CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every split's states are in its shared memory
    if (split == 0 && d < DH) {
      const Merged r = merge_states<DH>(
          S * W,
          [&](int i) {
            return cluster.map_shared_rank(comb, i / W) + (i % W) * (DH + 2);
          },
          d);
      out[row_out * DH + d] = r.o / fmaxf(r.l, 1e-30f);
    }
    cluster.sync();  // no block leaves while its states are being read
  } else {
    __syncthreads();
    if (d < DH) {
      const Merged r = merge_states<DH>(
          W, [&](int i) { return comb + i * (DH + 2); }, d);
      const size_t slot_id = row_out * S + split;
      part_acc[slot_id * DH + d] = r.o;
      if (d == 0) {
        part_ml[slot_id * 2] = r.m;
        part_ml[slot_id * 2 + 1] = r.l;
      }
    }
  }
}

// Merge the S splits of each row, in split order: one warp per row.  A
// split that saw no key carries (NEG_INF or the NEG_INF/2 floor, 0, 0)
// and weighs nothing; a row no split saw comes out exactly 0.
template <int DH>
__global__ void __launch_bounds__(NT) merge_splits_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    float* __restrict__ out, int n_rows, int S) {
  const int row = blockIdx.x * W + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* ml = part_ml + static_cast<size_t>(row) * S * 2;
  float m = NEG_INF;
  for (int s = 0; s < S; ++s) m = fmaxf(m, ml[s * 2]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) l += expf(ml[s * 2] - m) * ml[s * 2 + 1];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const float* pa = part_acc + static_cast<size_t>(row) * S * DH;
  for (int d = lane; d < DH; d += 32) {
    float o = 0.f;
    for (int s = 0; s < S; ++s) o += expf(ml[s * 2] - m) * pa[s * DH + d];
    out[static_cast<size_t>(row) * DH + d] = o * inv;
  }
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
  int B, H, NB, BT, MB, split_blocks;
  float scale;
  int mask_mode;
  cudaStream_t stream;
};

template <int QK, int KV, int DH>
cudaError_t launch(const Args& a) {
  constexpr int row = DH * static_cast<int>(sizeof(typename Kv<KV>::T));
  constexpr int max_rows = max_tile_rows<KV, DH>();
  const int S = num_splits(a.MB, a.split_blocks);
  const int tile_rows = a.BT < max_rows ? a.BT : max_rows;
  const int n_rows = a.B * a.H;
  const bool clustered = S <= MAX_CLUSTER;
  float* part_ml = clustered ? nullptr : static_cast<float*>(a.scratch);
  float* part_acc =
      clustered ? nullptr : part_ml + static_cast<size_t>(n_rows) * S * 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.H, a.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(W) * NST * 2 * tile_rows * row
                         + static_cast<size_t>(W) * (DH + 2) * sizeof(float);
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  if (clustered) {
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<QK, KV, DH>, a.q,
      static_cast<const uint8_t*>(a.k), static_cast<const uint8_t*>(a.v),
      static_cast<const __half*>(a.k_scale),
      static_cast<const __half*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.positions),
      static_cast<float*>(a.out), part_ml, part_acc, a.H, a.NB, a.BT, a.MB,
      S, a.split_blocks, tile_rows, a.scale, a.mask_mode);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || clustered) return e;
  merge_splits_kernel<DH><<<(n_rows + W - 1) / W, NT, 0, a.stream>>>(
      part_ml, part_acc, static_cast<float*>(a.out), n_rows, S);
  return cudaGetLastError();
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
// with the argument list of `hvd_paged_prefill`; C must be 1.  Every
// pointer is a device pointer; the scale pointers are null for f32/bf16
// pools.  The pools must be 16-byte aligned.  With S = ceil(MB /
// split_blocks) > 8, `scratch` holds B*H*S*(Dh + 2) floats; it is unused
// (may be null) otherwise.  Launches on `stream` and does not
// synchronise.  Returns the cudaError_t of the launches (0 on success).
extern "C" int hvd_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* out, void* scratch, int B, int C, int H,
    int Dh, int NB, int BT, int MB, int split_blocks, float scale,
    int mask_mode, int q_kind, int kv_kind, void* stream) {
  if (C != 1 || BT < 1 || BT > MAX_BT || NB < 1 || MB < 0 || H < 1
      || split_blocks < 1 || split_blocks > MAX_SPLIT_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               scratch, B, H, NB, BT, MB, split_blocks, scale, mask_mode,
               static_cast<cudaStream_t>(stream)};
  switch (q_kind) {
    case Q_F32: return static_cast<int>(by_pool<Q_F32>(a, Dh, kv_kind));
    case Q_BF16: return static_cast<int>(by_pool<Q_BF16>(a, Dh, kv_kind));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
