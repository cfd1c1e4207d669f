// Paged attention for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (horovod_tpu/serve/paged_attention.py:156, launched by `_paged_call`
// :236 behind `paged_decode_attention` :287 and `paged_prefill_attention`
// :309).  It computes the same function: attention of the queries
// q [B, C, H, Dh] (C = 1 for a decode step, a prompt chunk for prefill)
// against one layer's K/V block pool [NB, BT, H, Dh], read through the
// block tables [B, MB]:
//   * a table entry >= NB (the hole sentinel) is never a key, in every
//     mask mode; a key block wholly past the tile's last query is skipped
//     (`block_contributes`);
//   * the mask is on absolute positions: query positions[b] + row against
//     key j*BT + col (MASK_NONE / MASK_CAUSAL / MASK_STRICT);
//   * int8 and fp8 (e4m3fn) pools are dequantized on load with their f16
//     scale rows [NB, BT, H]; f32 and bf16 pools load as they are;
//   * scores and the online softmax are f32, the running max floored at
//     NEG_INF/2 and the sum at 1e-30, so a row that sees no key is exactly
//     0; the output is f32.
//
// Design.  The TPU kernel's grid (B, H, MB) runs its last dimension in
// order on one core and carries the softmax state in VMEM between grid
// steps.  Thread blocks on Hopper run in no order, so here one thread
// block owns one (sequence b, head h, tile of TQ query rows, split of
// SPLIT_BLOCKS logical blocks) and loops over the logical blocks j of its
// split of its own table row, holding the online-softmax state in shared
// memory.  Per contributing block it loads the BT x Dh K and V tile with
// 16-byte loads, all issued before the first is used, dequantizes them
// into shared memory, takes the tile's scores (a score's dot product is
// spread over G lanes when the tile has few query rows, as in decode),
// masks them, folds them into the online softmax one warp per row, and
// updates the f32 accumulator.  A table wider than one split is cut into
// ceil(MB / SPLIT_BLOCKS) splits that run in parallel (flash-decoding);
// each writes its unnormalised (max, sum, accumulator) and a second
// kernel merges the splits of a row in split order.  The split count
// depends on the table width only, never on the batch, there are no
// atomics, and a (b, h) result depends on no other row: a request gets
// the same bits alone or in a batch (the engine's batched == single
// contract).
//
// Bound.  The kernel is memory-bound: it must read the K and V bytes of
// the live context once (plus q and the scales) and does 4*Dh flops per
// (query, key) pair, far under the card's flop rate per byte.  gpt2-small
// in f32 at B=8 with 1024-token contexts reads 8*1024*768*4*2 ~= 50.3 MB
// per layer, ~15 us at 3.35 TB/s; a decode step launches it num_layers
// (12) times.  The splits put enough loads in flight to approach that:
// one thread block per (b, h) would leave 96 blocks for 132 SMs, each
// walking its 64 logical blocks one after another.  It is still simple:
// no TMA, no wgmma, scalar f32 math (prefill is far from its bound).

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MASK_NONE = 0;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_STRICT = 2;
constexpr int TQ = 16;            // query rows per thread block
constexpr int NT = 128;           // threads per block: 4 warps
constexpr int MAX_BT = 64;        // largest block_tokens the kernel takes
constexpr int VPT = 4;            // 16-byte K (and V) loads per thread per round

enum QKind { Q_F32 = 0, Q_BF16 = 1 };
enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2, KV_FP8 = 3 };

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <int KV> struct Kv;
template <> struct Kv<KV_F32> {
  using T = float;
  static __device__ __forceinline__ float cvt(T x) { return x; }
};
template <> struct Kv<KV_BF16> {
  using T = uint16_t;
  static __device__ __forceinline__ float cvt(T x) { return bf16_to_float(x); }
};
template <> struct Kv<KV_INT8> {
  using T = int8_t;
  static __device__ __forceinline__ float cvt(T x) {
    return static_cast<float>(x);
  }
};
template <> struct Kv<KV_FP8> {
  using T = uint8_t;  // float8_e4m3fn bits; every value is exact in f16
  static __device__ __forceinline__ float cvt(T x) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int k_stride(int dh) { return dh + 1; }

// Splits of a table row; at least one, so an empty table still writes 0s.
inline int num_splits(int mb, int split_blocks) {
  return mb > split_blocks ? (mb + split_blocks - 1) / split_blocks : 1;
}

__host__ __device__ inline size_t smem_floats(int dh, int bt) {
  // q tile, K tile (padded rows), V tile, scores, accumulator, m/l/corr
  return static_cast<size_t>(TQ) * dh + static_cast<size_t>(bt) * k_stride(dh)
         + static_cast<size_t>(bt) * dh + static_cast<size_t>(TQ) * bt
         + static_cast<size_t>(TQ) * dh + 3 * TQ;
}

// part_* hold one split's unnormalised state per query row:
// part_ml [rows][S][2] (max, sum), part_acc [rows][S][DH], where a row is
// (b * C + query) * H + h.  Unused (null) when S == 1.
template <int QK, int KV, int DH>
__global__ void __launch_bounds__(NT) paged_attention_kernel(
    const void* __restrict__ q_, const void* __restrict__ k_,
    const void* __restrict__ v_, const __half* __restrict__ k_scale,
    const __half* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int C, int H,
    int NB, int BT, int MB, int S, int split_blocks, float scale,
    int mask_mode) {
  using KT = typename Kv<KV>::T;
  constexpr bool kQuantized = KV == KV_INT8 || KV == KV_FP8;
  constexpr int KS = k_stride(DH);  // padding: keys of one warp hit distinct banks
  constexpr int VE = 16 / sizeof(KT);  // elements per 16-byte load
  const KT* kp = static_cast<const KT*>(k_);
  const KT* vp = static_cast<const KT*>(v_);
  const int split = blockIdx.x % S;
  const int q0 = (blockIdx.x / S) * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(TQ, C - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;               // [TQ][DH], pre-scaled
  float* ks = qs + TQ * DH;       // [BT][KS]
  float* vs = ks + BT * KS;       // [BT][DH]
  float* ps = vs + BT * DH;       // [TQ][BT] scores, then probabilities
  float* acc = ps + TQ * BT;      // [TQ][DH]
  float* m_s = acc + TQ * DH;     // [TQ] running max
  float* l_s = m_s + TQ;          // [TQ] running sum
  float* c_s = l_s + TQ;          // [TQ] this block's correction

  for (int i = tid; i < TQ * DH; i += NT) {
    const int r = i / DH;
    const int d = i % DH;
    float x = 0.f;
    if (r < rows) {
      const size_t off =
          ((static_cast<size_t>(b) * C + q0 + r) * H + h) * DH + d;
      x = QK == Q_F32 ? static_cast<const float*>(q_)[off]
                      : bf16_to_float(static_cast<const uint16_t*>(q_)[off]);
    }
    qs[i] = x * scale;
    acc[i] = 0.f;
  }
  if (tid < TQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int q_lo = positions[b] + q0;
  const int q_hi = q_lo + rows - 1;
  // G lanes share one score's dot product; G divides 32, so a group of
  // lanes never straddles a warp and the xor-shuffle stays inside it.
  const int npairs = rows * BT;
  int G = NT / npairs;
  G = G >= 32 ? 32 : G >= 16 ? 16 : G >= 8 ? 8 : G >= 4 ? 4 : G >= 2 ? 2 : 1;
  const int groups = NT / G;
  const int iters = (npairs + groups - 1) / groups;
  const int nvec = BT * DH / VE;  // 16-byte loads per K (or V) tile
  const int j_end = min(MB, (split + 1) * split_blocks);

  for (int j = split * split_blocks; j < j_end; ++j) {
    const int t = tables[static_cast<size_t>(b) * MB + j];
    const int k_lo = j * BT;
    bool contributes = t >= 0 && t < NB;  // holes are never keys
    if (mask_mode == MASK_CAUSAL) contributes = contributes && k_lo <= q_hi;
    if (mask_mode == MASK_STRICT) contributes = contributes && k_lo < q_hi;
    if (!contributes) continue;  // the same verdict for every thread

    // Stage the tile: every load of a round is in flight before the first
    // is converted, so a round costs one trip to memory.
    const size_t tile = static_cast<size_t>(t) * BT;
    for (int base = 0; base < nvec; base += NT * VPT) {
      uint4 kr[VPT], vr[VPT];
      float ksc[VPT], vsc[VPT];
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int vi = base + u * NT + tid;
        if (vi < nvec) {
          const int r = vi * VE / DH;
          const int d = vi * VE % DH;
          const size_t off = ((tile + r) * H + h) * DH + d;
          kr[u] = *reinterpret_cast<const uint4*>(kp + off);
          vr[u] = *reinterpret_cast<const uint4*>(vp + off);
          if (kQuantized) {
            ksc[u] = __half2float(k_scale[(tile + r) * H + h]);
            vsc[u] = __half2float(v_scale[(tile + r) * H + h]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int vi = base + u * NT + tid;
        if (vi < nvec) {
          const int r = vi * VE / DH;
          const int d = vi * VE % DH;
          const KT* ke = reinterpret_cast<const KT*>(&kr[u]);
          const KT* ve = reinterpret_cast<const KT*>(&vr[u]);
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            float kx = Kv<KV>::cvt(ke[e]);
            float vx = Kv<KV>::cvt(ve[e]);
            if (kQuantized) {
              kx *= ksc[u];
              vx *= vsc[u];
            }
            ks[r * KS + d + e] = kx;
            vs[r * DH + d + e] = vx;
          }
        }
      }
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      const int p = it * groups + tid / G;
      const int g = tid % G;
      float part = 0.f;
      if (p < npairs) {
        const float* qr = qs + (p / BT) * DH;
        const float* kr = ks + (p % BT) * KS;
        for (int d = g; d < DH; d += G) part = fmaf(qr[d], kr[d], part);
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (p < npairs && g == 0) {
        const int r = p / BT;
        const int c = p % BT;
        const int qpos = q_lo + r;
        const int kpos = k_lo + c;
        const bool keep = mask_mode == MASK_NONE
                          || (mask_mode == MASK_CAUSAL ? qpos >= kpos
                                                       : qpos > kpos);
        ps[r * BT + c] = keep ? part : NEG_INF;
      }
    }
    __syncthreads();

    for (int r = warp; r < rows; r += NT / 32) {
      float mx = NEG_INF;
      for (int c = lane; c < BT; c += 32) mx = fmaxf(mx, ps[r * BT + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, mx), NEG_INF * 0.5f);
      float sum = 0.f;
      for (int c = lane; c < BT; c += 32) {
        const float e = expf(ps[r * BT + c] - m_new);
        ps[r * BT + c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * DH; i += NT) {
      const int r = i / DH;
      const int d = i % DH;
      const float* pr = ps + r * BT;
      float a = acc[i] * c_s[r];
      for (int c = 0; c < BT; ++c) a = fmaf(pr[c], vs[c * DH + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * DH; i += NT) {
    const int r = i / DH;
    const int d = i % DH;
    const size_t row = (static_cast<size_t>(b) * C + q0 + r) * H + h;
    if (S == 1) {
      out[row * DH + d] = acc[i] / fmaxf(l_s[r], 1e-30f);
    } else {
      const size_t slot = row * S + split;
      part_acc[slot * DH + d] = acc[i];
      if (d == 0) {
        part_ml[slot * 2] = m_s[r];
        part_ml[slot * 2 + 1] = l_s[r];
      }
    }
  }
}

// Merge the S splits of each query row, in split order: one warp per row.
// A split that saw no key carries (NEG_INF or the NEG_INF/2 floor, 0, 0)
// and weighs nothing; a row no split saw comes out exactly 0.
template <int DH>
__global__ void __launch_bounds__(NT) merge_splits_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    float* __restrict__ out, int n_rows, int S) {
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
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
  int B, C, H, Dh, NB, BT, MB, split_blocks;
  float scale;
  int mask_mode;
  cudaStream_t stream;
};

template <int QK, int KV, int DH>
cudaError_t launch(const Args& a) {
  const int S = num_splits(a.MB, a.split_blocks);
  const dim3 grid(((a.C + TQ - 1) / TQ) * S, a.H, a.B);
  const size_t smem = smem_floats(DH, a.BT) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<QK, KV, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int n_rows = a.B * a.C * a.H;
  float* part_ml = S > 1 ? static_cast<float*>(a.scratch) : nullptr;
  float* part_acc =
      S > 1 ? part_ml + static_cast<size_t>(n_rows) * S * 2 : nullptr;
  paged_attention_kernel<QK, KV, DH><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, static_cast<const __half*>(a.k_scale),
      static_cast<const __half*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.positions),
      static_cast<float*>(a.out), part_ml, part_acc, a.C, a.H, a.NB, a.BT,
      a.MB, S, a.split_blocks, a.scale, a.mask_mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return e;
  const int per_block = NT / 32;
  merge_splits_kernel<DH><<<(n_rows + per_block - 1) / per_block, NT, 0,
                            a.stream>>>(part_ml, part_acc,
                                        static_cast<float*>(a.out), n_rows,
                                        S);
  return cudaGetLastError();
}

template <int QK, int KV>
cudaError_t by_head_dim(const Args& a) {
  switch (a.Dh) {
    case 16: return launch<QK, KV, 16>(a);
    case 32: return launch<QK, KV, 32>(a);
    case 64: return launch<QK, KV, 64>(a);
    case 128: return launch<QK, KV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int QK>
cudaError_t by_pool(const Args& a, int kv_kind) {
  switch (kv_kind) {
    case KV_F32: return by_head_dim<QK, KV_F32>(a);
    case KV_BF16: return by_head_dim<QK, KV_BF16>(a);
    case KV_INT8: return by_head_dim<QK, KV_INT8>(a);
    case KV_FP8: return by_head_dim<QK, KV_FP8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded through ctypes (horovod_tpu_torch/csrc/build.py).
// Every pointer is a device pointer; the scale pointers are null for
// f32/bf16 pools.  The pools must be 16-byte aligned.  With
// S = ceil(MB / split_blocks) > 1, `scratch` holds B*C*H*S*(Dh + 2)
// floats; it is unused (may be null) when S == 1.  Launches on `stream`
// and does not synchronise.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int hvd_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, void* out, void* scratch, int B, int C, int H,
    int Dh, int NB, int BT, int MB, int split_blocks, float scale,
    int mask_mode, int q_kind, int kv_kind, void* stream) {
  if (BT < 1 || BT > MAX_BT || NB < 1 || MB < 0 || H < 1
      || split_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               scratch, B, C, H, Dh, NB, BT, MB, split_blocks, scale,
               mask_mode, static_cast<cudaStream_t>(stream)};
  switch (q_kind) {
    case Q_F32: return static_cast<int>(by_pool<Q_F32>(a, kv_kind));
    case Q_BF16: return static_cast<int>(by_pool<Q_BF16>(a, kv_kind));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
