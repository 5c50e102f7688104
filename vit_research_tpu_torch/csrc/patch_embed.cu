// Fused normalise + patchify + project for Hopper (sm_90a).
//
// Replaces: vit_research_tpu/ops/patch_embed.py::_kernel (driven by
// _pallas_rows_project, public entry fused_patch_embed).
//
// Computes out[m, n] = sum_k (pix(m, k) * a[k] - b[k]) * W[k, n] + bias[n]
// for the (B*gh*gw, P*P*C) patch-row matrix of an NHWC image batch, where
// row m = (b, gy, gx) and column k = (py, px, c) fastest-last, exactly the
// layout of ops/patch_embed.py::patchify. Trailing image rows and columns
// that do not fill a patch are never read (VALID crop).
//
// What bounds it on the H100: at ViT-B/16 @224 (K = N = 768) it is a GEMM
// whose 2*M*K*N operations far outnumber its bytes (uint8 A operand, f32 W
// and output), so it is compute-bound. This first version accumulates in
// f32 on the CUDA cores (FMA), the precision of the TPU kernel's f32 dot,
// so it is bound by the f32 FMA rate rather than the tensor cores.
//
// What the design does about it: the A-tile load IS the patchify. Each
// block gathers its 128 patch rows straight from the uint8 (or f32) image,
// converts to f32 and applies the folded affine in registers before the
// tile lands in shared memory, so the normalised image never exists in
// device memory (the point of the TPU kernel). The product is a classic
// 128x128x8 register-blocked SGEMM: 256 threads, 8x8 outputs each, read
// from shared memory as float4. wgmma/TMA are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const TIn* __restrict__ img, const float* __restrict__ w,
                   const float* __restrict__ avec,
                   const float* __restrict__ bvec,
                   const float* __restrict__ bias, TOut* __restrict__ out,
                   int H, int W, int C, int P, int gw, int n_patches,
                   long long M, int K, int D) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A-tile loader: this thread always loads row (tid % BM) of the tile,
  // at tile columns kk = tid / BM + 2 * j, j = 0..3.
  const int a_row = tid & (BM - 1);
  const int a_kk0 = tid >> 7;  // 0 or 1
  const long long m_ld = m0 + a_row;
  const bool row_ok = m_ld < M;
  long long row_base = 0;
  if (row_ok) {
    const long long bi = m_ld / n_patches;
    const int pi = (int)(m_ld - bi * n_patches);
    const int gy = pi / gw;
    const int gx = pi - gy * gw;
    row_base = ((bi * H + (long long)gy * P) * W + (long long)gx * P) * C;
  }
  const int pc = P * C;
  const long long img_row_stride = (long long)W * C;

  // Compute mapping: rows {ty*4 + i, 64 + ty*4 + i}, cols likewise on tx,
  // so every shared-memory read is a conflict-free float4.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = a_kk0 + 2 * j;
      const int k = k0 + kk;
      float v = 0.f;
      if (row_ok && k < K) {
        const int py = k / pc;
        const int rem = k - py * pc;  // px * C + c, contiguous in memory
        const float x = to_f32(img[row_base + py * img_row_stride + rem]);
        // No contraction into an FMA: (x * a) - b rounds like the plain
        // version's two separate tensor ops.
        v = __fsub_rn(__fmul_rn(x, avec[k]), bvec[k]);
      }
      As[kk][a_row] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * THREADS;
      const int kk = idx / BN;
      const int nn = idx - kk * BN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < D) ? w[(long long)k * D + n] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (n < D) store_out(&out[m * D + n], acc[i][j] + bias[n]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* img, const void* w, const void* avec, const void* bvec,
           const void* bias, void* out, int B, int H, int W, int C, int P,
           int D, cudaStream_t stream) {
  const int gh = H / P;
  const int gw = W / P;
  const int n_patches = gh * gw;
  const long long M = (long long)B * n_patches;
  const int K = P * P * C;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((D + BN - 1) / BN));
  patch_embed_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(img), static_cast<const float*>(w),
      static_cast<const float*>(avec), static_cast<const float*>(bvec),
      static_cast<const float*>(bias), static_cast<TOut*>(out), H, W, C, P,
      gw, n_patches, M, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// images (B, H, W, C) NHWC contiguous, uint8 (in_u8 = 1) or f32;
// w (P*P*C, D), avec/bvec (P*P*C,), bias (D,) f32;
// out (B * (H/P) * (W/P), D), f32 (out_bf16 = 0) or bf16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vrt_patch_embed(const void* img, const void* w,
                               const void* avec, const void* bvec,
                               const void* bias, void* out, int B, int H,
                               int W, int C, int P, int D, int in_u8,
                               int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_bf16 ? launch<uint8_t, __nv_bfloat16>(img, w, avec, bvec, bias,
                                                     out, B, H, W, C, P, D, s)
                    : launch<uint8_t, float>(img, w, avec, bvec, bias, out, B,
                                             H, W, C, P, D, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(img, w, avec, bvec, bias, out,
                                                 B, H, W, C, P, D, s)
                  : launch<float, float>(img, w, avec, bvec, bias, out, B, H,
                                         W, C, P, D, s);
}
