// Kernel A's wgmma variant for Hopper's own units: normalise + patchify +
// project uint8 NHWC frames on the wgmma mainloop of wg_gemm.cuh.
//
// Replaces: vit_research_tpu/ops/patch_embed.py::_kernel (driven by
// _pallas_rows_project, public entry fused_patch_embed) for uint8 images,
// the engine's and the main path's input; vrt_patch_embed_u8 in
// csrc/patch_embed.cu routes here by its rule and keeps the mma.sync
// variant for a forced call. float32 images keep patch_embed.cu's CUDA-core
// kernel.
//
// Computes what the mma.sync variant computes: out = pix @ W' + c, with the
// affine folded into W' and c by the wrapper and W' split into three bf16
// pieces (hi + mid + lo, 24 significand bits). Every pixel (exact in bf16)
// times a piece is exact, and the sums are f32 on the tensor cores: each
// 16-deep k-step issues three wgmma, pixels x (lo, mid, hi), into one
// accumulator, the order of the mma.sync variant's SplitW3. The folded bias
// is added in the epilogue. Any B, H, W, C, P and D.
//
// What bounds it on the H100: at ViT-B/16 @224 (K = D = 768) the tensor
// cores: 0.060 ms of bf16 work at B = 256, three passes of it (0.180 ms) for
// the f32 semantics; and W's three pieces, which every 128-row block reads
// whole through L2 (6 bytes a k x column).
//
// What the design does about it:
// - The row operand. Each consumer warp gathers its own 16 patch rows of
//   a stage straight from the image (16-byte loads where P*C, W*C and the
//   base allow, byte by byte otherwise, as PatchRowsU8 does), widens them to
//   bf16 in registers and stores them into a 128-byte-swizzled slot (two
//   slots, 16 KB each). It issues a stage's loads two stages ahead and stores
//   them after the stage before completed, so their latency hides behind a
//   whole stage of wgmma; a warp writes only the rows its own wgmma reads.
// - W's pieces by TMA through the mainloop's ring (three stages of 48 KB:
//   3 pieces x 128 columns x 64 k; a fourth, with the output staged in the
//   ring behind a barrier of both warpgroups, measured 9% slower).
// - Blocks of two warpgroups (128 x 128 tiles) are persistent: a grid of the
//   blocks that fit at once (one an SM) walks the tiles, column tiles
//   fastest, so the blocks in flight share their image rows and W in L2,
//   and the ring runs on from one tile into the next during its epilogue.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "patch_embed.cuh"
#include "wg_gemm.cuh"

namespace {

using PeCfg = wg::Cfg<2, 1, 3, 3>;
// row slots: stage j + 1's rows are stored once stage j - 1's were read
constexpr int SLOTS = 2;
constexpr int ROWS_BYTES = SLOTS * PeCfg::WGS_M * wg::CHUNK;

// Products of every k-step: pixels x (lo, mid, hi) into one accumulator.
struct SplitW3 {
  __device__ static constexpr int piece(int p) { return 2 - p; }
};

// out = acc + c[n], the folded bias (0 past N).
struct AddBias {
  const float* c;
  int N;
  __device__ __forceinline__ float2 bias2(int col) const {
    return make_float2(col < N ? __ldg(c + col) : 0.f,
                       col + 1 < N ? __ldg(c + col + 1) : 0.f);
  }
  __device__ __forceinline__ float apply(float v, float b) const {
    return v + b;
  }
};

// The row operand: stage j's 64 k-bytes of each of the block's BM patch
// rows, in slot j % 2 (the warpgroup wm's 64 rows at wm * CHUNK). A
// thread holds two 16-byte chunks of its warp's 16 rows: rows
// (lane + 32 i) / 4 at k-offset 16 (lane % 4).
template <class C>
struct PatchRowsWg {
  PatchGeometry geo;
  wg::PersistentTiles<C> tiles;
  char* base;
  long long M;
  int kt, total;
  int cur_t;
  long long rbase[2];  // image offset of each chunk's row's first pixel
  bool ok[2];
  uint32_t v[2][4];

  __device__ __forceinline__ int row(int i) const {
    return 16 * ((threadIdx.x >> 5) & 3) + (((threadIdx.x & 31) + 32 * i) >> 2);
  }

  __device__ __forceinline__ void set_tile(int t) {
    long long m0;
    int n0;
    tiles.tile(t, m0, n0);
    const int wm = (threadIdx.x >> 7) / C::WGS_N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + wm * 64 + row(i);
      ok[i] = m < M;
      rbase[i] = 0;
      if (ok[i]) {
        const long long bi = m / geo.n_patches;
        const int pi = (int)(m - bi * geo.n_patches);
        const int gy = pi / geo.gw, gx = pi - (pi / geo.gw) * geo.gw;
        rbase[i] = ((bi * geo.H + (long long)gy * geo.P) * geo.W +
                    (long long)gx * geo.P) * geo.C;
      }
    }
    cur_t = t;
  }

  __device__ __forceinline__ void load(int j) {
    const int t = j / kt, ks = j - t * kt;
    if (t != cur_t) set_tile(t);
    const int k = ks * wg::BK + 16 * (threadIdx.x & 3);
    const int pc = geo.P * geo.C;
    const long long row_stride = (long long)geo.W * geo.C;
    if (geo.vec) {
      const int py = k / pc;
      const long long off = py * row_stride + (k - py * pc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 r = make_uint4(0u, 0u, 0u, 0u);
        if (ok[i] && k < geo.K)
          r = __ldg(reinterpret_cast<const uint4*>(geo.img + rbase[i] + off));
        v[i][0] = r.x;
        v[i][1] = r.y;
        v[i][2] = r.z;
        v[i][3] = r.w;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int w = 0; w < 4; ++w) v[i][w] = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b) {  // unrolled: v stays in registers
        const int kb = k + b;
        if (ok[i] && kb < geo.K) {
          const int py = kb / pc;
          const uint32_t byte =
              geo.img[rbase[i] + py * row_stride + (kb - py * pc)];
          v[i][b >> 2] |= byte << (8 * (b & 3));
        }
      }
    }
  }

  // 16 bytes -> 16 bf16 (exact: at most 8 significant bits), two 16-byte
  // units of the row in the swizzle.
  __device__ __forceinline__ void store(int j) const {
    const int wm = (threadIdx.x >> 7) / C::WGS_N;
    char* chunk = base + (j % SLOTS) * C::WGS_M * wg::CHUNK + wm * wg::CHUNK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t h[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        h[2 * w] = hop::pack_bf16((float)(v[i][w] & 0xffu),
                                  (float)((v[i][w] >> 8) & 0xffu));
        h[2 * w + 1] = hop::pack_bf16((float)((v[i][w] >> 16) & 0xffu),
                                      (float)(v[i][w] >> 24));
      }
      wg::store_units(chunk, row(i), threadIdx.x & 3, h);
    }
  }

  __device__ __forceinline__ void init() {
    cur_t = -1;
    if (total > 0) {
      load(0);
      store(0);
    }
    if (total > 1) load(1);
    hop::fence_proxy_async();
  }
  // stage j's rows, stored by the warpgroup's four warps, before its wgmma
  __device__ __forceinline__ void before(int) const {
    hop::named_sync(1 + (threadIdx.x >> 7), 128);
  }
  __device__ __forceinline__ uint64_t desc(int j, int, int wm) const {
    return hop::sw128_desc(base + (j % SLOTS) * C::WGS_M * wg::CHUNK +
                           wm * wg::CHUNK);
  }
  // stage j + 1's rows into the slot stage j - 1 left (its wgmma are done),
  // then stage j + 2's loads
  __device__ __forceinline__ void after(int j) {
    if (j + 1 >= total) return;
    store(j + 1);
    hop::fence_proxy_async();
    if (j + 2 < total) load(j + 2);
  }
};

template <typename TO>
__global__ void __launch_bounds__(PeCfg::THREADS, 1)
patch_embed_wg(const __grid_constant__ CUtensorMap wmap,
               const PatchGeometry geo, const float* __restrict__ c,
               TO* __restrict__ out, long long M, int D, bool vec_out,
               int n_nt, int n_st) {
  extern __shared__ char smem_raw[];
  char* smem = wg::align_1024(smem_raw);
  const wg::PersistentTiles<PeCfg> tiles{n_nt, n_st, (int)blockIdx.x,
                                         (int)gridDim.x};
  const int kt = (geo.K + wg::BK - 1) / wg::BK;
  PatchRowsWg<PeCfg> rows{geo, tiles, smem, M, kt, tiles.count() * kt};
  wg::gemm<PeCfg, SplitW3>(rows, tiles, &wmap, geo.K, AddBias{c, D}, out,
                           M, D, vec_out, smem, ROWS_BYTES);
}

// Per device: the blocks of each instantiation that fit at once.
int g_resident[64][2];

template <typename TO>
int launch(const CUtensorMap& map, const PatchGeometry& geo, const void* c,
           void* out, long long M, int D, cudaStream_t s) {
  constexpr int bytes = PeCfg::bytes(ROWS_BYTES);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  int& resident = g_resident[dev][sizeof(TO) == 2];
  if (resident == 0) {
    resident = wg::resident_blocks<PeCfg>(patch_embed_wg<TO>, bytes);
    if (resident == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_nt = (D + PeCfg::BN - 1) / PeCfg::BN;
  const long long n_st = (M + PeCfg::BM - 1) / PeCfg::BM * n_nt;
  if (n_st > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n_st < resident ? n_st : resident);
  const bool vec_out = (D * (int)sizeof(TO)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return wg::launch<PeCfg>(patch_embed_wg<TO>, grid, bytes, s, map, geo,
                           static_cast<const float*>(c),
                           static_cast<TO*>(out), M, D, vec_out, n_nt,
                           (int)n_st);
}

}  // namespace

static_assert(PeCfg::bytes(ROWS_BYTES) <= 232448, "one block an SM");

int patch_embed_wg_launch(const void* img, const void* w3, int ldw,
                          const void* c, void* out, int B, int H, int W,
                          int C, int P, int D, int out_bf16,
                          cudaStream_t stream) {
  const PatchGeometry geo = patch_geometry(img, H, W, C, P);
  const long long M = (long long)B * geo.n_patches;
  if (M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  if (!wg::weight_map(&map, w3, 3, geo.K, ldw))
    return (int)cudaErrorInvalidValue;
  return out_bf16 ? launch<__nv_bfloat16>(map, geo, c, out, M, D, stream)
                  : launch<float>(map, geo, c, out, M, D, stream);
}
