// What kernel C's two variants share (csrc/fused_ln.cu: the mma.sync
// variant on tc_gemm.cuh; csrc/fused_ln_wg.cu: the wgmma variant on
// wg_gemm.cuh): the activations, the epilogue, the unpacking of x's
// 16-byte chunks, the variant rule and the wgmma variant's entry point.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// The variant rule (mirrored in ops/fused_ln.py::ln_variants): the wgmma
// variant takes a bf16 W while the block's K-wide slab of normalised rows
// fits in shared memory beside W's ring (1 <= K <= LN_WG_MAX_K); an f32 W
// (3xTF32: TF32 wgmma reads only K-major operands, and the per-k-step
// flush would need a second accumulator tile) and a longer K stay on the
// mma.sync variant.
constexpr int LN_WG_MAX_K = 768;

// The codes of vrt_ln_matmul's variant argument.
enum LnVariant { LN_RULE = 0, LN_MMA = 1, LN_WG = 2 };

// ln_gemm_wg (csrc/fused_ln_wg.cu) with vrt_ln_matmul's arguments (w bf16
// (K, ldw)); returns a cudaError_t.
int ln_matmul_wg_launch(const void* x, const void* gamma, const void* beta,
                        const void* w, const void* bias, void* out,
                        long long M, int K, int N, int ldw, float eps,
                        int act, int x_bf16, int out_bf16,
                        cudaStream_t stream);

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v * 0.5f * (1.f + erff(v * 0.70710678118654752440f));
  if (act == 2) {
    const float inner = 0.79788456080286535588f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + tanhf(inner));
  }
  return v;
}

// The epilogue: the bias and the activation in f32. The mma.sync
// mainloop's asks for column n's output (0 past N); the wgmma mainloop's
// loads the bias of columns col and col + 1 first (0 past N), then asks
// for each output.
struct BiasAct {
  const float* bias;
  int N, act;
  __device__ __forceinline__ float operator()(float v, int n) const {
    return n < N ? activate(v + bias[n], act) : 0.f;
  }
  __device__ __forceinline__ float2 bias2(int col) const {
    return make_float2(col < N ? __ldg(bias + col) : 0.f,
                       col + 1 < N ? __ldg(bias + col + 1) : 0.f);
  }
  __device__ __forceinline__ float apply(float v, float b) const {
    return activate(v + b, act);
  }
};

// Value e of a 16-byte chunk of x (4 f32 or 8 bf16).
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ float elem(const uint4& r, int e, float) {
  return __uint_as_float(word(r, e));
}
__device__ __forceinline__ float elem(const uint4& r, int e, __nv_bfloat16) {
  const uint32_t w = word(r, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

}  // namespace
