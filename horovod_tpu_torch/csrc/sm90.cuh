// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels,
// flash_attention_fwd_sm90.cu (the bf16 forward),
// flash_attention_bwd_sm90.cu (the bf16 backward pair) and, for the
// addressing, masks and launch geometry, flash_attention_bwd_tf32_sm90.cu
// (the f32 backward pair): the [B, S, H, D]
// addressing and mask rules, PTX wrappers for mbarriers, TMA tile copies
// and wgmma, the 128-byte-swizzled shared-memory descriptors, the
// accumulator register layout, and on the host the 4-D tensor maps.
//
// Everything here has internal linkage (an unnamed namespace): each source
// that includes it gets its own copy, so the sources link into one library
// without clashing.  The conventions (see flash_attention_bwd_sm90.cu's
// note): one warpgroup of 128 threads owns a tile of ROWS = 64 rows;
// operand tiles are bf16 [rows][64k + c] stored as 64-column chunks of
// [rows][64] with the 128-byte swizzle; a head dim below 64 is zero-padded
// to one chunk by TMA.

#pragma once

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
// Host side: tensor maps, shared-memory limits, launch geometry
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

}  // namespace
