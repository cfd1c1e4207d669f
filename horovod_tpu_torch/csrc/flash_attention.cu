// FlashAttention-2 forward and backward for NVIDIA Hopper (sm_90a),
// written by hand.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/parallel/flash.py:
//   * hvd_flash_fwd     <- `_fwd_kernel` (:125, launched by `_flash_fwd`
//                          :268): out = softmax(mask(q*scale . k^T)) . v and
//                          the per-row logsumexp;
//   * hvd_flash_bwd_dq  <- `_bwd_dq_kernel` (:158, `_run_bwd_kernels` :319):
//                          p = exp(s - lse), ds = p * (dO . v^T - delta),
//                          dQ = scale * sum_k ds . k;
//   * hvd_flash_bwd_dkv <- `_bwd_dkv_kernel` (:195, `_run_bwd_kernels`
//                          :339): dV = sum_q p^T . dO,
//                          dK = sum_q ds^T . (q * scale).
// The forward runs this file's SIMT kernel for f32 operands and a
// tensor-core kernel (wgmma fed by TMA) for bf16 ones, in
// flash_attention_fwd_sm90.cu.  The backward pair runs on the tensor cores
// for both: bf16 operands on wgmma (flash_attention_bwd_sm90.cu), f32 ones
// on mma.sync TF32 in split precision (flash_attention_bwd_tf32_sm90.cu,
// three TF32 passes a product, which hold the JAX f32 tolerance where one
// would not).
// Layout: q, k, v, dO and the outputs are [B, S, H, D] with the head dim
// contiguous and any (16-byte multiple) strides for B, S and H, so q/k/v
// sliced out of the fused qkv projection are read where they lie (the JAX
// wrapper transposes to [B*H, S, D] instead).  lse and delta are f32
// [B, H, S].  Inputs are all f32 or all bf16 (`kind`); this file's
// kernel takes f32 and runs every product and the softmax in f32.
// Masks: NONE, CAUSAL (q >= k), STRICT (q > k) on positions in the
// sequence.
//
// Design.  The TPU grid (B*H, q blocks, k blocks) runs its last axis in
// order on one core and carries the softmax state in VMEM between grid
// steps.  Here one thread block of 256 threads owns one (b, h, tile of 64
// query rows) and loops over the key tiles up to the last one the mask
// lets contribute, holding that state in registers.
// Each tile is staged in shared memory with 16-byte loads and converted
// to f32.  Thread (ty, tx) of the 16 x 16 grid computes the 4 x 4 scores
// of rows ty + 16i and columns tx + 16j (row stride D + 1 floats, so the
// 16 rows a warp reads sit in 16 banks), the row max and sum reduce over
// the 16 lanes of a row with shuffles, and the accumulators of rows
// ty + 16i, columns tx + 16c stay in registers.  No atomics: every output
// element is summed by one thread in a fixed order, so two runs give the
// same bits.  A row that sees no key (STRICT row 0) gives out 0 and
// lse = NEG_INF/2 + log(1e-30): the running max starts at the NEG_INF/2
// floor, so the value does not depend on whether the row's tile was
// computed or skipped.
//
// Bound.  The forward does 4*S*S*D flops per (b, h) against 4*S*D
// elements moved (a causal mask halves the flops).  At BERT-large's 128
// tokens the card's least time is set by the bytes (the forward's 33.8 MB
// at 3.35 TB/s, ~10 us), at GPT-2's 1024 causal tokens the bytes and the
// bf16 tensor-core rate nearly tie.  This kernel computes in scalar f32
// from shared memory, off the tensor cores (whose bf16 rate is ~15x the
// f32 rate), so its own limit is the f32 FMA pipe and the shared-memory
// reads feeding it; three TF32 passes on the tensor cores, as the f32
// backward pair runs, are its next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MASK_NONE = 0;
constexpr int MASK_CAUSAL = 1;
constexpr int MASK_STRICT = 2;
constexpr int TILE = 64;  // rows of a query tile and of a key tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr int TR = 4;     // rows per thread (TILE / 16)
constexpr int PS = TILE + 1;  // row stride of a [TILE][TILE] probability tile

enum Kind { K_F32 = 0, K_BF16 = 1 };

// Element strides of one [B, S, H, D] operand (D is unit stride).
struct Str {
  long long b, s, h;
};

__device__ __forceinline__ size_t at(const Str& st, int b, int s, int h) {
  return static_cast<size_t>(b) * st.b + static_cast<size_t>(s) * st.s
         + static_cast<size_t>(h) * st.h;
}

// Reduce over the 16 lanes that hold one row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool keep(int mode, int qp, int kp) {
  return mode == MASK_NONE || (mode == MASK_CAUSAL ? qp >= kp : qp > kp);
}

// Stage rows [row0, row0 + TILE) of one (b, h) slice into dst[TILE][D + 1]
// as f32 times `mul`, with 16-byte loads; rows past S become zeros.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const Str& st, int b, int h, int row0,
                                      int S, float mul) {
  constexpr int VE = 4;        // floats per 16-byte load
  constexpr int VPR = D / VE;         // loads per row
  for (int i = threadIdx.x; i < TILE * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VE;
    float* d = dst + r * (D + 1) + c;
    if (row0 + r < S) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + at(st, b, row0 + r, h) + c);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < VE; ++j) d[j] = e[j] * mul;
    } else {
#pragma unroll
      for (int j = 0; j < VE; ++j) d[j] = 0.f;
    }
  }
}

// Keys a query tile ending at q_hi may see, exclusive (block_contributes).
__device__ __forceinline__ int key_end(int mode, int q_hi, int S) {
  if (mode == MASK_CAUSAL) return min(S, q_hi + 1);
  if (mode == MASK_STRICT) return min(S, q_hi);
  return S;
}

// out [B, S, H, D], lse [B, H, S].  Grid (S / TILE, H, B).
template <int D>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const float* __restrict__ q,
    const float* __restrict__ k,
    const float* __restrict__ v, float* out,
    float* __restrict__ lse, Str sq, Str sk, Str sv, Str so, int S, int H,
    float scale, int mode) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float sm[];
  float* qs = sm;              // [TILE][DP], pre-scaled
  float* ks = qs + TILE * DP;  // [TILE][DP]
  float* vs = ks + TILE * DP;  // [TILE][DP]
  float* ps = vs + TILE * DP;  // [TILE][PS] probabilities
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;

  stage<D>(qs, q, sq, b, h, q0, S, scale);
  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF * 0.5f;  // the floor, from the start
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = key_end(mode, min(q0 + TILE, S) - 1, S);

  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    stage<D>(ks, k, sk, b, h, k0, S, 1.f);
    stage<D>(vs, v, sv, b, h, k0, S, 1.f);
    __syncthreads();
    float s[TR][TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[TR], kv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < TR; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= S || !keep(mode, qp, kp)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float pv[TR], vv[DC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    float* o = out + at(so, b, r, h);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] / lf;
    if (tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + r] = m[i] + logf(lf);
  }
}

constexpr size_t fwd_smem(int d) {
  return (3 * static_cast<size_t>(TILE) * (d + 1) + TILE * PS) * sizeof(float);
}
// Raise a kernel's dynamic shared-memory limit past the default 48 KB,
// once per device (bit d of `done`) rather than on every launch.
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

Str str(const long long* s, int i) { return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

struct Launch {
  int B, S, H;
  float scale;
  int mode;
  cudaStream_t stream;
  dim3 grid() const { return dim3((S + TILE - 1) / TILE, H, B); }
};

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const long long* st, const Launch& a) {
  const size_t smem = fwd_smem(D);
  static std::atomic<unsigned> smem_set{0};
  cudaError_t e = allow_smem(fwd_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  fwd_kernel<D><<<a.grid(), NT, smem, a.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, str(st, 0),
      str(st, 1), str(st, 2), str(st, 3), a.S, a.H, a.scale, a.mode);
  return cudaGetLastError();
}

// Dispatch on the head dim to F<D>(args...); returns from the caller.
#define HVD_FLASH_DISPATCH(F, D, ...)                               \
  do {                                                              \
    switch (D) {                                                    \
      case 16: return static_cast<int>(F<16>(__VA_ARGS__));         \
      case 32: return static_cast<int>(F<32>(__VA_ARGS__));         \
      case 64: return static_cast<int>(F<64>(__VA_ARGS__));         \
      case 128: return static_cast<int>(F<128>(__VA_ARGS__));       \
    }                                                               \
    return static_cast<int>(cudaErrorInvalidValue);                 \
  } while (0)

bool bad_args(int B, int S, int H, int mode) {
  return B < 0 || S < 0 || H < 1 || B > 65535 || H > 65535 || mode < 0
         || mode > 2;
}

}  // namespace

// The kernels on the tensor cores: bf16 (flash_attention_fwd_sm90.cu,
// flash_attention_bwd_sm90.cu) and the f32 backward pair
// (flash_attention_bwd_tf32_sm90.cu).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* strides, int B, int S, int H,
                   int D, float scale, int mode, cudaStream_t stream);
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int S, int H,
                      int D, float scale, int mode, cudaStream_t stream);
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int S, int H, int D, float scale, int mode,
                       cudaStream_t stream);
int flash_bwd_dq_tf32(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse, const float* delta,
                      void* dq, const long long* strides, int B, int S, int H,
                      int D, float scale, int mode, cudaStream_t stream);
int flash_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       void* dk, void* dv, const long long* strides, int B,
                       int S, int H, int D, float scale, int mode,
                       cudaStream_t stream);

// C interface, loaded through ctypes (horovod_tpu_torch/csrc/build.py).
// Every tensor pointer is a device pointer, 16-byte aligned.  `strides`
// is a host array of 3 int64 element strides (b, s, h) per [B, S, H, D]
// operand, in argument order; every stride times the element size must
// be a multiple of 16 bytes.  `kind` is 0 for f32, 1 for bf16 (every
// [B, S, H, D] operand has that type).  D is 16, 32, 64 or 128.  Each
// launches on `stream`, does not synchronise, and returns the
// cudaError_t of its launch (0 on success).

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int S, int H, int D, float scale,
                             int mask_mode, int kind, void* stream) {
  if (bad_args(B, S, H, mask_mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const Launch a{B, S, H, scale, mask_mode, static_cast<cudaStream_t>(stream)};
  if (kind == K_BF16)
    return flash_fwd_sm90(q, k, v, out, static_cast<float*>(lse), strides, B,
                          S, H, D, scale, mask_mode, a.stream);
  if (kind != K_F32) return static_cast<int>(cudaErrorInvalidValue);
  HVD_FLASH_DISPATCH(fwd, D, q, k, v, out, static_cast<float*>(lse),
                     strides, a);
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dO, const void* lse,
                                const void* delta, void* dq,
                                const long long* strides, int B, int S, int H,
                                int D, float scale, int mask_mode, int kind,
                                void* stream) {
  if (bad_args(B, S, H, mask_mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == K_BF16)
    return flash_bwd_dq_sm90(q, k, v, dO, static_cast<const float*>(lse),
                             static_cast<const float*>(delta), dq, strides, B,
                             S, H, D, scale, mask_mode, st);
  if (kind != K_F32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd_dq_tf32(q, k, v, dO, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), dq, strides, B,
                           S, H, D, scale, mask_mode, st);
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int S,
                                 int H, int D, float scale, int mask_mode,
                                 int kind, void* stream) {
  if (bad_args(B, S, H, mask_mode)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == K_BF16)
    return flash_bwd_dkv_sm90(q, k, v, dO, static_cast<const float*>(lse),
                              static_cast<const float*>(delta), dk, dv,
                              strides, B, S, H, D, scale, mask_mode, st);
  if (kind != K_F32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_bwd_dkv_tf32(q, k, v, dO, static_cast<const float*>(lse),
                            static_cast<const float*>(delta), dk, dv, strides,
                            B, S, H, D, scale, mask_mode, st);
}
