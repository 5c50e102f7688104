// Fused normalise + patchify + project for Hopper (sm_90a): kernel A's
// entry points, its uint8 mma.sync variant and its f32 CUDA-core kernel.
//
// Replaces: vit_research_tpu/ops/patch_embed.py::_kernel (driven by
// _pallas_rows_project, public entry fused_patch_embed).
// vrt_patch_embed_u8 takes the wgmma variant of csrc/patch_embed_wg.cu by
// its rule (patch_embed.cuh) and this file's mma.sync variant when forced.
//
// Computes out[m, n] = sum_k (pix(m, k) * a[k] - b[k]) * W[k, n] + bias[n]
// for the (B*gh*gw, P*P*C) patch-row matrix of an NHWC image batch, where
// row m = (b, gy, gx) and column k = (py, px, c) fastest-last, exactly the
// layout of ops/patch_embed.py::patchify. Trailing image rows and columns
// that do not fill a patch are never read (VALID crop). Any B, H, W, C, P
// and D: the tails of K and D are zero-filled.
//
// What bounds it on the H100: at ViT-B/16 @224 (K = D = 768) it is a GEMM
// whose 2*M*K*D operations outnumber its bytes (uint8 image, W, output):
// 0.060 ms of bf16 tensor-core work against 0.058 ms of bytes at B = 256
// with f32 out. The f32 semantics of the TPU kernel's dot cost this design
// three bf16 passes, so its own floor is 3 x 0.060 ms.
//
// What the design does about it (uint8 images, the engine's and the main
// path's input): the affine is folded into the weight by the wrapper,
// W'[k, n] = a[k] W[k, n] and c[n] = bias[n] - sum_k b[k] W[k, n], so out =
// pix @ W' + c. uint8 pixels are exact in bf16, and W' is split into three
// bf16 pieces (hi + mid + lo, 24 significand bits), so every pixel x piece
// product is exact and the sum is f32: f32 accuracy on the bf16 tensor
// cores (tc_gemm.cuh, Plan lo, mid, hi). The producer gathers the patch
// rows straight from the image, 16 bytes a thread where P*C, W*C and the
// base allow (every patch row of P*C bytes is contiguous), byte by byte
// otherwise, and converts them to bf16 in registers, so the normalised
// image never exists in device memory (the point of the TPU kernel).
//
// float32 images are on no path of the port (the engine ships uint8): they
// keep the first version, a 128x128x8 register-blocked f32 SGEMM on the
// CUDA cores whose tile loader applies the affine (patch_embed_f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "patch_embed.cuh"
#include "tc_gemm.cuh"

namespace {

// ------------------------------------------------- uint8, tensor cores

// Products of every k-step: pixels x (lo, mid, hi) into one accumulator.
// The tensor cores' truncating adds cost 2.0e-5 at K = 768 and 5.7e-5 at
// K = 3072 against the f32 plain version (H100, chip_smoke.py phase 2),
// inside the 1e-4 bound; summing each k-step from 0 first (FLUSH) would
// bring them to 4e-6 / 8e-6 and cost 20% of the time.
struct SplitW3 {
  static constexpr int NA = 1, NB = 3, NP = 3;
  static constexpr bool FLUSH = false;
  __host__ __device__ static constexpr int a(int) { return 0; }
  __host__ __device__ static constexpr int b(int p) { return 2 - p; }
};
// Two blocks of 8 warps an SM. A 256 x 128 tile of 16 warps, which halves
// the L2 re-reads of W's pieces, measured no faster (0.5897 against 0.5586
// ms at B = 256, H100, chip_smoke.py phase 2).
using U8Tile = tc::Tile<128, 128, 2, 4>;
constexpr int U8_STAGES = 3;

using Geometry = PatchGeometry;

// Producer: the stage's BM rows x 32 k-values (bytes) in 16-byte chunks;
// chunk i = tid + j * THREADS is row i / 2 at k-offset 16 * (i % 2).
template <class Tl>
struct PatchRowsU8 {
  static constexpr int THREADS = Tl::THREADS;
  static constexpr int PER = Tl::BM * 2 / THREADS;
  static_assert(Tl::BM * 2 % THREADS == 0, "whole chunks per thread");
  const Geometry geo;
  long long row_base[PER];  // image offset of the patch's first pixel
  bool row_ok[PER];
  int half;
  uint32_t v[PER][4];

  __device__ PatchRowsU8(const Geometry& g, long long m0, long long M)
      : geo(g) {
    half = threadIdx.x & 1;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const long long m = m0 + ((threadIdx.x + j * THREADS) >> 1);
      row_ok[j] = m < M;
      row_base[j] = 0;
      if (row_ok[j]) {
        const long long bi = m / g.n_patches;
        const int pi = (int)(m - bi * g.n_patches);
        const int gy = pi / g.gw, gx = pi - (pi / g.gw) * g.gw;
        row_base[j] = ((bi * g.H + (long long)gy * g.P) * g.W +
                       (long long)gx * g.P) * g.C;
      }
    }
  }

  __device__ __forceinline__ void load(int k0) {
    const int k = k0 + half * 16;
    const int pc = geo.P * geo.C;
    const long long row_stride = (long long)geo.W * geo.C;
    if (geo.vec) {
      const int py = k / pc;
      const long long off = py * row_stride + (k - py * pc);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        uint4 r = make_uint4(0u, 0u, 0u, 0u);
        if (row_ok[j] && k < geo.K)
          r = __ldg(reinterpret_cast<const uint4*>(geo.img + row_base[j] +
                                                   off));
        v[j][0] = r.x;
        v[j][1] = r.y;
        v[j][2] = r.z;
        v[j][3] = r.w;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int w = 0; w < 4; ++w) v[j][w] = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b) {  // unrolled: v stays in registers
        const int kb = k + b;
        if (row_ok[j] && kb < geo.K) {
          const int py = kb / pc;
          const uint32_t byte =
              geo.img[row_base[j] + py * row_stride + (kb - py * pc)];
          v[j][b >> 2] |= byte << (8 * (b & 3));
        }
      }
    }
  }

  // 16 bytes -> 16 bf16 (exact: at most 8 significant bits), 32 bytes of
  // the tile row.
  __device__ __forceinline__ void store(char* stage) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      uint32_t h[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        h[2 * w] = tc::pack_bf16((float)(v[j][w] & 0xffu),
                                 (float)((v[j][w] >> 8) & 0xffu));
        h[2 * w + 1] = tc::pack_bf16((float)((v[j][w] >> 16) & 0xffu),
                                     (float)(v[j][w] >> 24));
      }
      uint4* dst = reinterpret_cast<uint4*>(
          stage + ((threadIdx.x + j * THREADS) >> 1) * tc::A_LD + half * 32);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
};

// out = acc + c[n], the folded bias.
struct AddBias {
  const float* c;
  int N;
  __device__ __forceinline__ float operator()(float v, int n) const {
    return n < N ? v + c[n] : 0.f;
  }
};

template <typename TOut>
__global__ void __launch_bounds__(U8Tile::THREADS, U8Tile::MIN_BLOCKS)
patch_embed_u8(const Geometry geo, const __nv_bfloat16* __restrict__ w3,
               int ldw, const float* __restrict__ c, TOut* __restrict__ out,
               long long M, int D, bool vec_out) {
  extern __shared__ uint4 smem_u4[];
  long long m0;
  int n0;
  tc::tile_of_block<U8Tile>(D, m0, n0);
  PatchRowsU8<U8Tile> prod(geo, m0, M);
  tc::gemm_tile<tc::Bf16Op, U8Tile, SplitW3, U8_STAGES>(
      prod, w3, (long long)geo.K * ldw, ldw, geo.K, AddBias{c, D}, out, M, D,
      m0, n0, vec_out, reinterpret_cast<char*>(smem_u4));
}

template <typename TOut>
int launch_u8(const void* img, const void* w3, int ldw, const void* c,
              void* out, int B, int H, int W, int C, int P, int D,
              cudaStream_t s) {
  const Geometry geo = patch_geometry(img, H, W, C, P);
  const long long M = (long long)B * geo.n_patches;
  const bool vec_out = (D * (int)sizeof(TOut)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using L = tc::Layout<tc::Bf16Op, U8Tile, 1, 3, U8_STAGES, TOut>;
  return tc::launch<U8Tile>(patch_embed_u8<TOut>, M, D, L::BYTES, s, geo,
                            static_cast<const __nv_bfloat16*>(w3), ldw,
                            static_cast<const float*>(c),
                            static_cast<TOut*>(out), M, D, vec_out);
}

// --------------------------------------------- float32, CUDA cores

constexpr int S_THREADS = 256;
constexpr int S_BM = 128;
constexpr int S_BN = 128;
constexpr int S_BK = 8;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TOut>
__global__ void __launch_bounds__(S_THREADS)
patch_embed_f32(const float* __restrict__ img, const float* __restrict__ w,
                const float* __restrict__ avec,
                const float* __restrict__ bvec,
                const float* __restrict__ bias, TOut* __restrict__ out,
                int H, int W, int C, int P, int gw, int n_patches,
                long long M, int K, int D) {
  __shared__ __align__(16) float As[S_BK][S_BM];
  __shared__ __align__(16) float Bs[S_BK][S_BN];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * S_BM;
  const int n0 = blockIdx.y * S_BN;

  // A-tile loader: this thread always loads row (tid % S_BM) of the tile,
  // at tile columns kk = tid / S_BM + 2 * j, j = 0..3.
  const int a_row = tid & (S_BM - 1);
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

  for (int k0 = 0; k0 < K; k0 += S_BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = a_kk0 + 2 * j;
      const int k = k0 + kk;
      float v = 0.f;
      if (row_ok && k < K) {
        const int py = k / pc;
        const int rem = k - py * pc;  // px * C + c, contiguous in memory
        const float x = img[row_base + py * img_row_stride + rem];
        // No contraction into an FMA: (x * a) - b rounds like the plain
        // version's two separate tensor ops.
        v = __fsub_rn(__fmul_rn(x, avec[k]), bvec[k]);
      }
      As[kk][a_row] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * S_THREADS;
      const int kk = idx / S_BN;
      const int nn = idx - kk * S_BN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < D) ? w[(long long)k * D + n] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < S_BK; ++kk) {
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

template <typename TOut>
int launch_f32(const void* img, const void* w, const void* avec,
               const void* bvec, const void* bias, void* out, int B, int H,
               int W, int C, int P, int D, cudaStream_t stream) {
  const int gh = H / P;
  const int gw = W / P;
  const int n_patches = gh * gw;
  const long long M = (long long)B * n_patches;
  const int K = P * P * C;
  dim3 grid((unsigned)((M + S_BM - 1) / S_BM),
            (unsigned)((D + S_BN - 1) / S_BN));
  patch_embed_f32<TOut><<<grid, S_THREADS, 0, stream>>>(
      static_cast<const float*>(img), static_cast<const float*>(w),
      static_cast<const float*>(avec), static_cast<const float*>(bvec),
      static_cast<const float*>(bias), static_cast<TOut*>(out), H, W, C, P,
      gw, n_patches, M, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// uint8 images (B, H, W, C) NHWC contiguous; w3 (3, P*P*C, ldw) bf16, the
// hi, mid and lo pieces of the folded weight (ldw >= D a multiple of 8,
// columns past D zero, 16-byte aligned); c (D,) f32 the folded bias; out
// (B * (H/P) * (W/P), D), f32 (out_bf16 = 0) or bf16. variant (PeVariant):
// 0 the rule (the wgmma variant), 1 the mma.sync variant, 2 the wgmma
// variant. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int vrt_patch_embed_u8(const void* img, const void* w3, int ldw,
                                  const void* c, void* out, int B, int H,
                                  int W, int C, int P, int D, int out_bf16,
                                  int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ldw < D || ldw % 8 != 0) return (int)cudaErrorInvalidValue;
  if (variant == PE_RULE || variant == PE_WG)
    return patch_embed_wg_launch(img, w3, ldw, c, out, B, H, W, C, P, D,
                                 out_bf16, s);
  if (variant != PE_MMA) return (int)cudaErrorInvalidValue;
  return out_bf16 ? launch_u8<__nv_bfloat16>(img, w3, ldw, c, out, B, H, W,
                                             C, P, D, s)
                  : launch_u8<float>(img, w3, ldw, c, out, B, H, W, C, P, D,
                                     s);
}

// float32 images (B, H, W, C) NHWC contiguous; w (P*P*C, D), avec/bvec
// (P*P*C,), bias (D,) f32; out as above. Returns cudaGetLastError().
extern "C" int vrt_patch_embed_f32(const void* img, const void* w,
                                   const void* avec, const void* bvec,
                                   const void* bias, void* out, int B, int H,
                                   int W, int C, int P, int D, int out_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_f32<__nv_bfloat16>(img, w, avec, bvec, bias, out,
                                              B, H, W, C, P, D, s)
                  : launch_f32<float>(img, w, avec, bvec, bias, out, B, H, W,
                                      C, P, D, s);
}
