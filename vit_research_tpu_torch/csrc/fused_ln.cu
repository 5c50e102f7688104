// Fused LayerNorm + projection (+ bias, + GELU) for Hopper (sm_90a): kernel
// C's entry point and its mma.sync variant.
//
// Replaces: vit_research_tpu/ops/fused_ln.py::_kernel (driven by
// _ln_matmul_pallas, public entry ln_matmul). vrt_ln_matmul takes the
// variant of the rule in fused_ln.cuh: the wgmma variant of
// csrc/fused_ln_wg.cu for a bf16 W at K <= LN_WG_MAX_K, this file's
// mma.sync variant for an f32 W, a deeper K, or when forced.
//
// Computes out[m, n] = act(sum_k y[m, k] * W[k, n] + bias[n]) with
//   y[m, k] = round_W(((x[m, k] - mean_m) * rsqrt(var_m + eps)) * g[k] + b[k])
// where mean_m and var_m are row m's mean and centred variance over K in f32
// (two passes, not E[x^2] - E[x]^2), round_W rounds to W's dtype (a no-op
// for f32 W), the products accumulate in f32, and act is none, exact GELU
// (erff) or tanh-GELU. x is (M, K) f32 or bf16, W (K, N) f32 or bf16,
// gamma/beta (K,) and bias (N,) f32, out (M, N) f32 or bf16; all row-major
// and contiguous. Any M, K and N.
//
// What bounds it on the H100: at ViT-B shapes (M = B*197, K = 768, N = 768
// or 3072) the 2*M*K*N operations outnumber the bytes (x read once, W, the
// output written once), except bf16 W at N = 768, where the bytes bound it.
// The tensor cores give the floor: 989 TFLOP/s bf16, 495 TF32. With f32 W
// the f32 semantics cost this design three TF32 passes (its own floor is 3x
// the TF32 bound).
//
// What the design does about it: two kernels behind one entry point.
// ln_stats takes every row's mean and 1/std once (a warp per row, two
// passes in f32) into a (2, M) scratch buffer, so the GEMM blocks of the
// column tiles of a row block do not each recompute them. ln_gemm runs the
// tensor-core mainloop of tc_gemm.cuh with a producer that loads x (16
// bytes a thread where K and the base allow), normalises, applies gamma
// and beta in f32 in registers and rounds to W's operand type before the
// tile lands in shared memory, so the normalised (M, K) tensor never
// exists in device memory (the point of the TPU kernel):
//   - bf16 W: y rounded to bf16, one bf16 mma per k-step (the JAX kernel's
//     own arithmetic, y.astype(bf16) @ W with f32 accumulation);
//   - f32 W: 3xTF32. The producer stores y_hi = tf32(y) and y_lo = tf32(y -
//     y_hi) (hop::tf32_rna, cvt.rna's rounding); the wrapper splits W into
//     W_hi and W_lo the same way per call; each k-step sums y_hi W_lo,
//     y_lo W_hi, then y_hi W_hi from 0 and adds that to the f32
//     accumulator, which keeps f32 accuracy (a
//     single TF32 pass does not, nor do 1152 chained mma at K = 3072: the
//     tensor cores' adds truncate).
// A block is 16 warps on a 128 x 256 tile: x is the fat operand (f32, and
// normalised again by every column tile), and the wider tile halves both
// its L2 traffic and the producer's work per product while keeping 16
// warps on an SM; it ran 19-34% faster than 128 x 128 with 8 warps (H100,
// chip_smoke.py phase 3b). The epilogue adds the bias and the activation
// in f32 and rounds once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_ln.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int STATS_THREADS = 256;  // ln_stats: a warp per row
using tc::to_f32;

// Row statistics: warp w of block b takes row 8 b + w; stats[m] = mean,
// stats[M + m] = 1 / sqrt(var + eps).
template <typename TX>
__global__ void __launch_bounds__(STATS_THREADS)
ln_stats(const TX* __restrict__ x, float* __restrict__ stats, long long M,
         int K, float eps) {
  const int lane = threadIdx.x & 31;
  const long long m =
      (long long)blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;  // uniform across the warp
  const TX* row = x + m * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f32(row[k]);
  const float mean = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f32(row[k]) - mean;
    v = fmaf(d, d, v);
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)K + eps);
  if (lane == 0) {
    stats[m] = mean;
    stats[M + m] = rstd;
  }
}

__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Producer: the stage's BM rows x Op::BK values of y. Chunk i = tid + j *
// THREADS (j < PER, i < CHUNKS) is row i / CPR, values (i % CPR) * V ... +
// V - 1 of the stage, so neighbouring threads read neighbouring 16 bytes of
// a row.
template <typename TX, class Op, class Tl>
struct LnRows {
  static constexpr int BM = Tl::BM, THREADS = Tl::THREADS;
  static constexpr int V = 16 / (int)sizeof(TX);  // x values per chunk
  static constexpr int CPR = Op::BK / V;          // chunks per tile row
  static constexpr int CHUNKS = BM * CPR;
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr bool SPLIT = sizeof(typename Op::T) == 4;  // tf32 hi/lo
  static_assert(CHUNKS % THREADS == 0 || CHUNKS < THREADS, "whole chunks");
  static_assert(THREADS % CPR == 0, "a thread's chunks share their k");

  const TX* x;
  const float* gamma;
  const float* beta;
  long long M, m0;
  int K, k0;
  bool vec;  // 16-byte loads: K % V == 0 and x 16-byte aligned
  float mean[PER], rstd[PER];
  uint4 raw[PER];

  __device__ LnRows(const TX* x_, const float* stats, const float* g,
                    const float* b, long long M_, int K_, bool vec_,
                    long long m0_)
      : x(x_), gamma(g), beta(b), M(M_), m0(m0_), K(K_), k0(0), vec(vec_) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long m = m0 + (threadIdx.x + j * THREADS) / CPR;
      mean[j] = m < M ? stats[m] : 0.f;
      rstd[j] = m < M ? stats[M + m] : 0.f;
    }
  }

  __device__ __forceinline__ void load(int k0_) {
    k0 = k0_;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (CHUNKS < THREADS && i >= CHUNKS) break;  // an idle thread
      const long long m = m0 + i / CPR;
      const int k = k0 + (i % CPR) * V;
      if (vec) {
        raw[j] = m < M && k < K
                     ? __ldg(reinterpret_cast<const uint4*>(x + m * K + k))
                     : make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (m < M && k + e < K) {
          const uint32_t b = bits_of(x[m * K + k + e]);
          if constexpr (V == 4)
            wv[e] = b;
          else
            wv[e >> 1] |= b << (16 * (e & 1));
        }
      }
      raw[j] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    }
  }

  __device__ __forceinline__ void store(char* stage) const {
    // THREADS % CPR == 0: every chunk of this thread covers the same k,
    // so gamma and beta load once per stage.
    const int c = (threadIdx.x % CPR) * V;
    const int k = k0 + c;
    float g[V], b[V];
    if (vec && k < K) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 gq = __ldg(reinterpret_cast<const float4*>(gamma + k) + q);
        const float4 bq = __ldg(reinterpret_cast<const float4*>(beta + k) + q);
        g[4 * q] = gq.x, g[4 * q + 1] = gq.y, g[4 * q + 2] = gq.z,
        g[4 * q + 3] = gq.w;
        b[4 * q] = bq.x, b[4 * q + 1] = bq.y, b[4 * q + 2] = bq.z,
        b[4 * q + 3] = bq.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        g[e] = k + e < K ? __ldg(gamma + k + e) : 0.f;
        b[e] = k + e < K ? __ldg(beta + k + e) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (CHUNKS < THREADS && i >= CHUNKS) break;
      const int r = i / CPR;
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // No contraction into FMAs: ((x - mean) * rstd) * g + b rounds
        // like the plain version's separate tensor ops. Past K: 0.
        const float xn = __fmul_rn(
            __fsub_rn(elem(raw[j], e, TX()), mean[j]), rstd[j]);
        y[e] = k + e < K ? __fadd_rn(__fmul_rn(xn, g[e]), b[e]) : 0.f;
      }
      char* row = stage + r * tc::A_LD;
      if constexpr (SPLIT) {
        float hi[V], lo[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          hi[e] = tc::tf32_rna(y[e]);
          lo[e] = tc::tf32_rna(y[e] - hi[e]);
        }
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          *reinterpret_cast<float4*>(row + (c + 4 * q) * 4) =
              make_float4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2],
                          hi[4 * q + 3]);
          *reinterpret_cast<float4*>(row + BM * tc::A_LD + (c + 4 * q) * 4) =
              make_float4(lo[4 * q], lo[4 * q + 1], lo[4 * q + 2],
                          lo[4 * q + 3]);
        }
      } else {
        uint32_t h[V / 2];
#pragma unroll
        for (int e = 0; e < V / 2; ++e)
          h[e] = tc::pack_bf16(y[2 * e], y[2 * e + 1]);
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(row + c * 2) =
              make_uint4(h[0], h[1], h[2], h[3]);
        else
          *reinterpret_cast<uint2*>(row + c * 2) = make_uint2(h[0], h[1]);
      }
    }
  }
};

// bf16 W: one product. f32 W: pieces (y_hi, y_lo) x (W_hi, W_lo), products
// y_hi W_lo, y_lo W_hi, y_hi W_hi.
template <class Op>
struct LnPlan {
  static constexpr int NA = 1, NB = 1, NP = 1;
  static constexpr bool FLUSH = false;
  __host__ __device__ static constexpr int a(int) { return 0; }
  __host__ __device__ static constexpr int b(int) { return 0; }
};
template <>
struct LnPlan<tc::Tf32Op> {
  static constexpr int NA = 2, NB = 2, NP = 3;
  static constexpr bool FLUSH = true;
  __host__ __device__ static constexpr int a(int p) { return p == 1 ? 1 : 0; }
  __host__ __device__ static constexpr int b(int p) { return p == 0 ? 1 : 0; }
};
template <class Op>
constexpr int LN_STAGES = sizeof(typename Op::T) == 4 ? 3 : 4;
using LnTile = tc::Tile<128, 256, 2, 8>;

template <typename TX, class Op, typename TO>
__global__ void __launch_bounds__(LnTile::THREADS, LnTile::MIN_BLOCKS)
ln_gemm(const TX* __restrict__ x, const float* __restrict__ stats,
        const float* __restrict__ gamma, const float* __restrict__ beta,
        const typename Op::T* __restrict__ w, int ldw,
        const float* __restrict__ bias, TO* __restrict__ out, long long M,
        int K, int N, int act, bool vec_x, bool vec_out) {
  extern __shared__ uint4 smem_u4[];
  long long m0;
  int n0;
  tc::tile_of_block<LnTile>(N, m0, n0);
  LnRows<TX, Op, LnTile> prod(x, stats, gamma, beta, M, K, vec_x, m0);
  tc::gemm_tile<Op, LnTile, LnPlan<Op>, LN_STAGES<Op>>(
      prod, w, (long long)K * ldw, ldw, K, BiasAct{bias, N, act}, out, M, N,
      m0, n0, vec_out, reinterpret_cast<char*>(smem_u4));
}

template <typename TX, class Op, typename TO>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           int ldw, const void* bias, void* out, float* stats, long long M,
           int K, int N, float eps, int act, cudaStream_t s) {
  const TX* xt = static_cast<const TX*>(x);
  constexpr int rows = STATS_THREADS / 32;
  ln_stats<TX><<<(unsigned)((M + rows - 1) / rows), STATS_THREADS, 0, s>>>(
      xt, stats, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = K % (16 / (int)sizeof(TX)) == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = (N * (int)sizeof(TO)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using Plan = LnPlan<Op>;
  using L = tc::Layout<Op, LnTile, Plan::NA, Plan::NB, LN_STAGES<Op>, TO>;
  return tc::launch<LnTile>(
      ln_gemm<TX, Op, TO>, M, N, L::BYTES, s, xt, (const float*)stats,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const typename Op::T*>(w), ldw,
      static_cast<const float*>(bias), static_cast<TO*>(out), M, K, N, act,
      vec_x, vec_out);
}

template <typename TX, class Op>
int launch_out(int out_bf16, const void* x, const void* gamma,
               const void* beta, const void* w, int ldw, const void* bias,
               void* out, float* stats, long long M, int K, int N, float eps,
               int act, cudaStream_t s) {
  return out_bf16 ? launch<TX, Op, __nv_bfloat16>(x, gamma, beta, w, ldw,
                                                  bias, out, stats, M, K, N,
                                                  eps, act, s)
                  : launch<TX, Op, float>(x, gamma, beta, w, ldw, bias, out,
                                          stats, M, K, N, eps, act, s);
}

template <typename TX>
int launch_w(int w_bf16, int out_bf16, const void* x, const void* gamma,
             const void* beta, const void* w, int ldw, const void* bias,
             void* out, float* stats, long long M, int K, int N, float eps,
             int act, cudaStream_t s) {
  return w_bf16 ? launch_out<TX, tc::Bf16Op>(out_bf16, x, gamma, beta, w,
                                             ldw, bias, out, stats, M, K, N,
                                             eps, act, s)
                : launch_out<TX, tc::Tf32Op>(out_bf16, x, gamma, beta, w,
                                             ldw, bias, out, stats, M, K, N,
                                             eps, act, s);
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; gamma, beta (K,) f32; bias (N,) f32;
// out (M, N) f32 (out_bf16 = 0) or bf16; stats: 2 * M f32 of scratch (the
// mma.sync variant's; null for the wgmma variant's).
// w: bf16 (w_bf16 = 1) (K, ldw), or f32 (2, K, ldw), the TF32 pieces W_hi
// and W_lo; ldw >= N a multiple of 16 bytes, columns past N zero, 16-byte
// aligned. act: 0 none, 1 exact GELU, 2 tanh-GELU. variant (LnVariant): 0
// the rule (fused_ln.cuh: the wgmma variant for a bf16 W at 1 <= K <=
// LN_WG_MAX_K, else mma.sync), 1 the mma.sync variant, 2 the wgmma variant
// (cudaErrorInvalidValue where the rule does not offer it). mma.sync
// launches the stats pass then the GEMM. Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int vrt_ln_matmul(const void* x, const void* gamma,
                             const void* beta, const void* w,
                             const void* bias, void* out, void* stats,
                             long long M, int K, int N, int ldw, float eps,
                             int act, int x_bf16, int w_bf16, int out_bf16,
                             int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K < 0 || N <= 0 || ldw < N ||
      ldw % (w_bf16 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  const bool wg_takes = w_bf16 && K >= 1 && K <= LN_WG_MAX_K;
  if (variant == LN_RULE) variant = wg_takes ? LN_WG : LN_MMA;
  if (variant == LN_WG) {
    if (!wg_takes) return (int)cudaErrorInvalidValue;
    return ln_matmul_wg_launch(x, gamma, beta, w, bias, out, M, K, N, ldw,
                               eps, act, x_bf16, out_bf16, s);
  }
  if (variant != LN_MMA || !stats) return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  return x_bf16 ? launch_w<__nv_bfloat16>(w_bf16, out_bf16, x, gamma, beta,
                                          w, ldw, bias, out, st, M, K, N, eps,
                                          act, s)
                : launch_w<float>(w_bf16, out_bf16, x, gamma, beta, w, ldw,
                                  bias, out, st, M, K, N, eps, act, s);
}
