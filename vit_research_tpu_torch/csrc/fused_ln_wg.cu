// Kernel C's wgmma variant for Hopper's own units: LayerNorm + projection
// (+ bias, + GELU) with a bf16 W, on the wgmma mainloop of wg_gemm.cuh.
//
// Replaces: vit_research_tpu/ops/fused_ln.py::_kernel (driven by
// _ln_matmul_pallas, public entry ln_matmul) for a bf16 W at 1 <= K <=
// LN_WG_MAX_K (the rule in fused_ln.cuh; vrt_ln_matmul in csrc/fused_ln.cu
// routes here and keeps the mma.sync variant for the rest).
//
// Computes what the mma.sync variant computes with a bf16 W, rounding for
// rounding: y[m, k] = bf16(((x[m, k] - mean_m) * rstd_m) * g[k] + b[k]),
// with no contraction into FMAs, mean_m and rstd_m = rsqrt(var_m + eps)
// from the row's mean, then its centred variance, in f32; the products
// accumulated in f32; the bias and exact or tanh-GELU in f32; one rounding
// to the output type. x (M, K) f32 or bf16, out (M, N) f32 or bf16.
//
// What bounds it on the H100: at the ViT-B sites (M = 50,432 or 100,864, K
// = 768, N = 768, 2,304 or 3,072) the tensor cores' 2 M K N operations
// (989 TFLOP/s), except at N = 768 with an f32 x, where x's bytes bound it;
// around the tensor cores, the LayerNorm before a block's first tile and
// each tile's epilogue (wg_gemm.cuh).
//
// What the design does about it, as the TPU kernel does (a row block
// normalised once against every column block of W):
// - A block owns 64 rows. Its 8 consumer warps take the rows' mean and
//   1/std themselves (a warp a row, four rows' loads in flight at a time,
//   the rows in registers: two passes in f32 over registers, not over
//   memory; gamma and beta held in registers for the warp's rows), so
//   there is no statistics launch and x is read once. Each writes its rows
//   of y, rounded to bf16, once into a K-wide slab in 128-byte-swizzled
//   shared memory (96 KB at K = 768), zero past K and past M.
// - Then the block walks its row block's column tiles of 256 (two
//   warpgroups, 128 columns each) on the slab, W streamed by TMA through
//   the mainloop's ring, which the producer warp starts filling before the
//   LayerNorm; the ring runs on across the column tiles.
// One block an SM: the slab and four stages of W (32 KB each) fill it, so
// LN_WG_MAX_K is 768.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_ln.cuh"
#include "wg_gemm.cuh"

namespace {

using LnCfg = wg::Cfg<1, 2, 1, 4>;
constexpr int SLAB_CHUNKS = (LN_WG_MAX_K + wg::BK - 1) / wg::BK;
static_assert(LnCfg::bytes(SLAB_CHUNKS * wg::CHUNK) <= 232448,
              "the slab at LN_WG_MAX_K fits beside the ring");

struct OnePiece {
  __device__ static constexpr int piece(int) { return 0; }
};

__device__ __forceinline__ float x_f32(float v) { return v; }
__device__ __forceinline__ float x_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The row operand: the block's 64 rows of y in a slab of kc chunks of 64
// k (chunk i at i * CHUNK), written once by init().
template <typename TX, class C>
struct LnSlab {
  static constexpr int V = 16 / (int)sizeof(TX);  // x values a 16-byte chunk
  // chunks a lane holds of a row: every chunk of the slab at LN_WG_MAX_K
  static constexpr int J = (SLAB_CHUNKS * 64 / V + 31) / 32;
  static constexpr int ROWS = 64 / (C::CONSUMERS / 32);  // a warp's rows
  static constexpr int RB = 4;  // rows a warp loads at once
  static_assert(ROWS % RB == 0, "whole rounds of rows");

  const TX* x;
  const float* gamma;
  const float* beta;
  char* slab;
  long long M, m0;
  int K, kc;
  float eps;
  bool vec;  // 16-byte loads of x, gamma and beta

  __device__ __forceinline__ void load_row(float (&v)[J][V], long long m,
                                           int lane) const {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = (lane + 32 * j) * V;
      if (m < M && k < K && vec) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + m * K + k));
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = elem(r, e, TX());
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[j][e] = m < M && k + e < K ? x_f32(x[m * K + k + e]) : 0.f;
      }
    }
  }

  // mean and 1 / std of a row held as v (0 past K)
  __device__ __forceinline__ void stats(const float (&v)[J][V], int lane,
                                        float& mean, float& rstd) const {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[j][e];
    mean = warp_sum(s) / (float)K;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[j][e] - mean;
        if ((lane + 32 * j) * V + e < K) q = fmaf(d, d, q);
      }
    rstd = rsqrtf(warp_sum(q) / (float)K + eps);
  }

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // gamma and beta of this lane's chunks, once for the warp's rows
    float g[J][V], b[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = (lane + 32 * j) * V;
      if (vec && k < K) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 gq =
              __ldg(reinterpret_cast<const float4*>(gamma + k) + q);
          const float4 bq =
              __ldg(reinterpret_cast<const float4*>(beta + k) + q);
          g[j][4 * q] = gq.x, g[j][4 * q + 1] = gq.y, g[j][4 * q + 2] = gq.z,
          g[j][4 * q + 3] = gq.w;
          b[j][4 * q] = bq.x, b[j][4 * q + 1] = bq.y, b[j][4 * q + 2] = bq.z,
          b[j][4 * q + 3] = bq.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          g[j][e] = k + e < K ? __ldg(gamma + k + e) : 0.f;
          b[j][e] = k + e < K ? __ldg(beta + k + e) : 0.f;
        }
      }
    }
    for (int i = 0; i < ROWS; i += RB) {
      const int r0 = warp * ROWS + i;
      float v[RB][J][V], mean[RB], rstd[RB];
#pragma unroll
      for (int h = 0; h < RB; ++h) load_row(v[h], m0 + r0 + h, lane);
#pragma unroll
      for (int h = 0; h < RB; ++h) stats(v[h], lane, mean[h], rstd[h]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = (lane + 32 * j) * V;
        if (k >= kc * 64) continue;
        // k's 16-byte unit in its chunk's swizzled rows (V = 4: its half)
        const int within = k & 63, u = within >> 3;
        char* chunk = slab + (k >> 6) * wg::CHUNK + (within & 7) * 2;
#pragma unroll
        for (int h = 0; h < RB; ++h) {
          const int r = r0 + h;
          const bool row_ok = m0 + r < M;
          uint32_t w[V / 2];
#pragma unroll
          for (int e = 0; e < V; e += 2) {
            float y[2];
#pragma unroll
            for (int d = 0; d < 2; ++d) {
              // No contraction into FMAs: ((x - mean) * rstd) * g + b
              // rounds like the plain version's separate tensor ops.
              const float xn = __fmul_rn(
                  __fsub_rn(v[h][j][e + d], mean[h]), rstd[h]);
              y[d] = row_ok && k + e + d < K
                         ? __fadd_rn(__fmul_rn(xn, g[j][e + d]), b[j][e + d])
                         : 0.f;
            }
            w[e / 2] = hop::pack_bf16(y[0], y[1]);
          }
          char* dst = chunk + r * 128 + ((u ^ (r & 7)) << 4);
          if constexpr (V == 8)
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
          else
            *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        }
      }
    }
    hop::fence_proxy_async();
    hop::named_sync(1, C::CONSUMERS);
  }
  __device__ __forceinline__ void before(int) const {}
  __device__ __forceinline__ uint64_t desc(int, int ks, int) const {
    return hop::sw128_desc(slab + ks * wg::CHUNK);
  }
  __device__ __forceinline__ void after(int) const {}
};

template <typename TX, typename TO>
__global__ void __launch_bounds__(LnCfg::THREADS, 1)
ln_gemm_wg(const __grid_constant__ CUtensorMap wmap, const TX* __restrict__ x,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           const float* __restrict__ bias, TO* __restrict__ out, long long M,
           int K, int N, float eps, int act, bool vec_x, bool vec_out) {
  extern __shared__ char smem_raw[];
  char* smem = wg::align_1024(smem_raw);
  const int kc = (K + wg::BK - 1) / wg::BK;
  LnSlab<TX, LnCfg> rows{x, gamma, beta, smem, M,
                         (long long)blockIdx.x * LnCfg::BM, K, kc, eps,
                         vec_x};
  const wg::ColumnTiles<LnCfg> tiles{rows.m0,
                                     (N + LnCfg::BN - 1) / LnCfg::BN};
  wg::gemm<LnCfg, OnePiece>(rows, tiles, &wmap, K, BiasAct{bias, N, act},
                            out, M, N, vec_out, smem, kc * wg::CHUNK);
}

template <typename TX, typename TO>
int launch(const CUtensorMap& map, const void* x, const void* gamma,
           const void* beta, const void* bias, void* out, long long M, int K,
           int N, float eps, int act, cudaStream_t s) {
  const bool vec_x =
      K % (16 / (int)sizeof(TX)) == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
       reinterpret_cast<uintptr_t>(beta)) % 16 == 0;
  const bool vec_out = (N * (int)sizeof(TO)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid = (unsigned)((M + LnCfg::BM - 1) / LnCfg::BM);
  const int kc = (K + wg::BK - 1) / wg::BK;
  return wg::launch<LnCfg>(
      ln_gemm_wg<TX, TO>, grid, LnCfg::bytes(kc * wg::CHUNK), s, map,
      static_cast<const TX*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, K, N, eps, act, vec_x, vec_out);
}

}  // namespace

int ln_matmul_wg_launch(const void* x, const void* gamma, const void* beta,
                        const void* w, const void* bias, void* out,
                        long long M, int K, int N, int ldw, float eps,
                        int act, int x_bf16, int out_bf16,
                        cudaStream_t stream) {
  if (K < 1 || K > LN_WG_MAX_K) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  if (!wg::weight_map(&map, w, 1, K, ldw)) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                          map, x, gamma, beta, bias, out, M, K, N, eps, act,
                          stream)
                    : launch<__nv_bfloat16, float>(map, x, gamma, beta, bias,
                                                   out, M, K, N, eps, act,
                                                   stream);
  return out_bf16 ? launch<float, __nv_bfloat16>(map, x, gamma, beta, bias,
                                                 out, M, K, N, eps, act,
                                                 stream)
                  : launch<float, float>(map, x, gamma, beta, bias, out, M, K,
                                         N, eps, act, stream);
}
