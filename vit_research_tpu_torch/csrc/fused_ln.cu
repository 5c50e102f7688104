// Fused LayerNorm + projection (+ bias, + GELU) for Hopper (sm_90a).
//
// Replaces: vit_research_tpu/ops/fused_ln.py::_kernel (driven by
// _ln_matmul_pallas, public entry ln_matmul).
//
// Computes out[m, n] = act(sum_k y[m, k] * W[k, n] + bias[n]) with
//   y[m, k] = round_W(((x[m, k] - mean_m) * rsqrt(var_m + eps)) * g[k] + b[k])
// where mean_m and var_m are row m's mean and centred variance over K in f32
// (two passes, not E[x^2] - E[x]^2), round_W rounds to W's dtype (a no-op
// for f32 W), the products accumulate in f32, and act is none, exact GELU
// (erff) or tanh-GELU. x is (M, K) f32 or bf16, W (K, N) f32 or bf16,
// gamma/beta (K,) and bias (N,) f32, out (M, N) f32 or bf16; all row-major
// and contiguous.
//
// What bounds it on the H100: at ViT-B shapes (M = B*197, K = 768, N = 768
// or 3072) the 2*M*K*N operations far outnumber the bytes (x read once, W,
// the output written once), so it is compute-bound. This first version
// keeps the TPU kernel's f32 accumulation on the CUDA cores (FMA), so its
// bound is the f32 FMA rate, not the tensor cores.
//
// What the design does about it: the TPU kernel held a (256, K) row block
// in VMEM and normalised it there. Here each block of 128 rows first takes
// its rows' statistics (one warp per row, lanes striding over K, two
// passes in f32) into shared memory; then a 128x128x8 register-blocked
// SGEMM (the patch-embed kernel's) runs, whose A-tile loader normalises,
// applies gamma/beta and rounds to W's dtype in registers before the tile
// lands in shared memory, so the normalised (M, K) tensor never exists in
// device memory. The epilogue adds the bias and the activation in f32.
// M is bounds-checked and N has no limit (the grid tiles it). wgmma/TMA are
// left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int AS_STRIDE = BM + 4;  // padding: conflict-free tile stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// y rounded to the weight dtype, as the reference casts LN(x) to W.dtype.
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(THREADS)
ln_matmul_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const TW* __restrict__ w,
                 const float* __restrict__ bias, TO* __restrict__ out,
                 long long M, int K, int N, float eps, int act) {
  __shared__ __align__(16) float As[BK][AS_STRIDE];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float s_mean[BM];
  __shared__ float s_rstd[BM];

  // One linear grid, column tiles fastest: the blocks that run together
  // share their rows of x, so the rows' statistics and A tiles are read
  // from L2 rather than from device memory once per column tile.
  const int tid = threadIdx.x;
  const int n_tiles = (N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * BM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;

  // Row statistics: warp `warp` takes rows warp, warp + 8, ...
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const long long m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {  // uniform across the warp
      const TX* row = x + m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f32(row[k]);
      mean = warp_sum(s) / (float)K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = to_f32(row[k]) - mean;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / (float)K + eps);
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
    }
  }
  __syncthreads();

  // A-tile loader: row (tid / 2) of the tile, 4 consecutive k from
  // (tid % 2) * 4, so two neighbouring threads read 8 consecutive elements.
  const int a_row = tid >> 1;
  const int a_kk0 = (tid & 1) * 4;
  const long long m_ld = m0 + a_row;
  const bool row_ok = m_ld < M;
  const TX* x_row = x + (row_ok ? m_ld : 0) * K;
  const float a_mean = s_mean[a_row];
  const float a_rstd = s_rstd[a_row];

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
      const int kk = a_kk0 + j;
      const int k = k0 + kk;
      float v = 0.f;
      if (row_ok && k < K) {
        // No contraction into FMAs: ((x - mean) * rstd) * g + b rounds
        // like the plain version's separate tensor ops.
        const float xn = __fmul_rn(__fsub_rn(to_f32(x_row[k]), a_mean),
                                   a_rstd);
        v = round_as(__fadd_rn(__fmul_rn(xn, gamma[k]), beta[k]), w);
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
      Bs[kk][nn] = (k < K && n < N) ? to_f32(w[(long long)k * N + n]) : 0.f;
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
      if (n < N) store_out(&out[m * N + n], activate(acc[i][j] + bias[n], act));
    }
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           const void* bias, void* out, long long M, int K, int N, float eps,
           int act, cudaStream_t stream) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  ln_matmul_kernel<TX, TW, TO><<<(unsigned)tiles, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, K, N, eps,
      act);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_out(int out_bf16, const void* x, const void* gamma,
               const void* beta, const void* w, const void* bias, void* out,
               long long M, int K, int N, float eps, int act,
               cudaStream_t s) {
  return out_bf16
             ? launch<TX, TW, __nv_bfloat16>(x, gamma, beta, w, bias, out, M,
                                             K, N, eps, act, s)
             : launch<TX, TW, float>(x, gamma, beta, w, bias, out, M, K, N,
                                     eps, act, s);
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; gamma, beta (K,) f32; w (K, N) f32
// (w_bf16 = 0) or bf16; bias (N,) f32; out (M, N) f32 (out_bf16 = 0) or
// bf16. act: 0 none, 1 exact GELU, 2 tanh-GELU.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vrt_ln_matmul(const void* x, const void* gamma,
                             const void* beta, const void* w,
                             const void* bias, void* out, long long M, int K,
                             int N, float eps, int act, int x_bf16,
                             int w_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? launch_out<__nv_bfloat16, __nv_bfloat16>(
                        out_bf16, x, gamma, beta, w, bias, out, M, K, N, eps,
                        act, s)
                  : launch_out<__nv_bfloat16, float>(
                        out_bf16, x, gamma, beta, w, bias, out, M, K, N, eps,
                        act, s);
  }
  return w_bf16 ? launch_out<float, __nv_bfloat16>(out_bf16, x, gamma, beta,
                                                    w, bias, out, M, K, N, eps,
                                                    act, s)
                : launch_out<float, float>(out_bf16, x, gamma, beta, w, bias,
                                           out, M, K, N, eps, act, s);
}
