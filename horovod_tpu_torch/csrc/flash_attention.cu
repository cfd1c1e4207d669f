// FlashAttention-2 forward and backward for NVIDIA Hopper (sm_90a): the C
// entry points and their dispatch by element type.
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
// Every kernel runs on the tensor cores.  bf16 operands take wgmma fed by
// TMA: the forward in flash_attention_fwd_sm90.cu, the backward pair in
// flash_attention_bwd_sm90.cu.  f32 operands take mma.sync TF32 in split
// precision, three TF32 passes a product, which hold the JAX f32
// tolerances where one pass would not: the forward in
// flash_attention_fwd_tf32_sm90.cu, the backward pair in
// flash_attention_bwd_tf32_sm90.cu.
// Layout: q, k, v, dO and the outputs are [B, S, H, D] with the head dim
// contiguous and any (16-byte multiple) strides for B, S and H, so q/k/v
// sliced out of the fused qkv projection are read where they lie (the JAX
// wrapper transposes to [B*H, S, D] instead).  lse and delta are f32
// [B, H, S].  Inputs are all f32 or all bf16 (`kind`).  Masks: NONE,
// CAUSAL (q >= k), STRICT (q > k) on positions in the sequence.

#include <cuda_runtime.h>

namespace {

enum Kind { K_F32 = 0, K_BF16 = 1 };

bool bad_args(int B, int S, int H, int mode) {
  return B < 0 || S < 0 || H < 1 || B > 65535 || H > 65535 || mode < 0
         || mode > 2;
}

}  // namespace

// The kernels: bf16 (flash_attention_fwd_sm90.cu,
// flash_attention_bwd_sm90.cu) and f32 (flash_attention_fwd_tf32_sm90.cu,
// flash_attention_bwd_tf32_sm90.cu).
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
int flash_fwd_tf32(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* strides, int B, int S, int H,
                   int D, float scale, int mode, cudaStream_t stream);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == K_BF16)
    return flash_fwd_sm90(q, k, v, out, static_cast<float*>(lse), strides, B,
                          S, H, D, scale, mask_mode, st);
  if (kind != K_F32) return static_cast<int>(cudaErrorInvalidValue);
  return flash_fwd_tf32(q, k, v, out, static_cast<float*>(lse), strides, B,
                        S, H, D, scale, mask_mode, st);
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
