// Hopper's own units, as the port's sm_90a kernels use them: mbarriers,
// TMA loads (tensor and 1-D bulk), wgmma's shared-memory descriptors and
// fences, and on the host the tensor-map encoder and a kernel's shared-
// memory limit.
// One home for what kernel B's wgmma variants (csrc/attention_wg.cu in
// bf16, csrc/attention_f32_wg.cu in f32 on split TF32 operands), its
// short-sequence f32 variant (csrc/attention_short.cu) and the wgmma GEMM
// mainloop of kernels A and C (csrc/wg_gemm.cuh) and the encoder linears'
// split-operand GEMM (csrc/gemm_f32_wg.cu) share.
//
// Everything is in namespace hop; nothing here launches or allocates.

#pragma once

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32 -> TF32 (10 explicit significand bits), round to nearest, ties away
// from zero; the low 13 bits of the result are 0. x = hi + lo with hi =
// tf32_rna(x) and lo = tf32_rna(x - hi) splits an f32 operand into the two
// TF32 pieces of a 3xTF32 product (hi hi + hi lo + lo hi). The value of
// cvt.rna.tf32.f32 for every finite x, by two integer instructions on its
// bits (half the weight of the 13 dropped bits added to the magnitude,
// then those bits cleared), which issue at the integer units' full rate:
// kernel B's f32 wgmma variant splits every K, V and P value it reads.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// After every mbar_init, before any other thread uses the barriers.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Waits for the completion of the barrier's phase of parity `parity`. A
// phase that never completes is a fault of the kernel: after some 2^30
// polls (seconds) it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma's operand reads, TMA) once a barrier orders them after this fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A named barrier (ids 1-15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- TMA

// `bytes` contiguous bytes of global memory at src into dst by one 1-D
// bulk copy, counted on bar's transaction bytes. src, dst and bytes are
// multiples of 16; no tensor map, so the host encodes nothing per call.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box of `map` at coordinates (c0, ...) into dst, counted on bar's
// transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor in the 128-byte swizzle (as TMA writes
// it: 16-byte chunk c of 128-byte row r at chunk c ^ (r % 8), 8-row groups
// of 1,024 bytes). lbo, sbo in bytes: for a K-major operand sbo is the
// stride of 8-row groups (1,024) and lbo is not read; for an MN-major one
// (read transposed) lbo is the stride of its 64-element atoms along M or N
// and sbo that of 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(const void* tile, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// A tile of 128-byte rows read K-major, or MN-major at N = 64 (one atom).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return smem_desc(tile, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// A K-major f32 tile of `rows` rows x 64 floats as TMA writes it in the
// 128-byte swizzle: a 128-byte row holds 32 floats, so the tile is two
// atoms along K (floats 0-31, then 32-63), each `rows` x 128 bytes. The
// descriptor of its TF32 k-step kk (8 floats, 32 bytes; kk < 8).
__device__ __forceinline__ uint64_t tf32_desc(const void* tile, int rows,
                                              int kk) {
  return sw128_desc(static_cast<const char*>(tile) + (kk >> 2) * rows * 128 +
                    (kk & 3) * 32);
}

// TF32 wgmma, m64n64k8, f32 accumulate: d (+)= A B, accumulating unless
// `accumulate` is 0. TF32 reads both operands K-major only (the transpose
// bits are f16/bf16's). B from shared memory (its descriptor); A from
// registers (a: the m16n8k8 tf32 A fragment of the warp's 16 rows: (g, c),
// (g + 8, c), (g, c + 4), (g + 8, c + 4) for g = lane / 4, c = lane % 4)
// or from shared memory (its descriptor).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Waits until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -------------------------------------------------------------------- host

// Above 48 KB of dynamic shared memory a kernel launches only after
// cudaFuncSetAttribute on the current device: raises Kernel's limit to
// `bytes` (the most it ever takes) once a kernel and device (a bit a
// device below 64; others set it every call). Returns a cudaError_t.
template <auto Kernel>
inline int raise_smem_limit(int bytes) {
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that the
// library links nothing beyond it; null where libcuda lacks it.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map of a (batch, heads, seq, dh) view of 2- or 4-byte elements
// (`type`, `elem` bytes) with element strides st (batch, head, token),
// in the 128-byte swizzle: boxes of `box_dh` elements of dh (128 bytes) by
// `rows` tokens, dh first, then the token, head and batch dims in order
// of stride (a dim of one has stride 0 from the wrapper and goes last,
// with the packed stride; its coordinate is always 0). slot: each of
// token, head, batch's coordinate (1 to 3). Rows past seq arrive as
// zeros. False where cuTensorMapEncodeTiled refuses the map (a stride
// that is not a multiple of 16 bytes or past 2^40).
inline bool head_map(CUtensorMap* map, int (&slot)[3], const void* base,
                     CUtensorMapDataType type, int elem, int dh, int box_dh,
                     int batch, int heads, int seq, const long long* st,
                     int rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const long long size[3] = {seq, heads, batch};
  const long long stride[3] = {st[2] * elem, st[1] * elem,
                               st[0] * elem};  // bytes
  int order[3] = {0, 1, 2};
  auto later = [&](int a, int b) {  // a dim of one last, else by stride
    const bool ua = size[a] == 1, ub = size[b] == 1;
    return ua != ub ? ua : (!ua && stride[a] > stride[b]);
  };
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (later(order[j], order[j + 1])) {
        const int t = order[j];
        order[j] = order[j + 1];
        order[j + 1] = t;
      }
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box_dh, 1, 1, 1}, step[4] = {1, 1, 1, 1};
  long long packed = (long long)dh * elem;
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    dims[i + 1] = (cuuint64_t)size[d];
    const long long s = size[d] == 1 ? packed : stride[d];
    strides[i] = (cuuint64_t)s;
    packed = s * size[d];
    if (d == 0) box[i + 1] = (cuuint32_t)rows;
    slot[d] = i + 1;
  }
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
