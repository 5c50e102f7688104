// One wgmma GEMM mainloop for Hopper (sm_90a), shared by kernel A's uint8
// variant (csrc/patch_embed_wg.cu) and kernel C's bf16-weight variant
// (csrc/fused_ln_wg.cu): out = epi(rows @ W), rows a bf16 operand that the
// block's own threads write (it is transformed on its way in, so it cannot
// come by TMA), W bf16 (K, ldw) row-major in NB pieces (K * ldw apart)
// whose products are summed into one f32 accumulator.
//
// What bounds it on the H100: the tensor cores (989 TFLOP/s bf16) at the
// kernels' ViT-B shapes, and around them what the tensor cores wait on:
// each stage's handshakes, each tile's epilogue and, in C, the LayerNorm
// before the first tile. clock64 stamps in one of C's blocks (N = 3072,
// GELU): a 64-deep stage ~650 cycles against 512 of wgmma, an epilogue
// 7-11k cycles a 64 x 256 tile against its k-loop's ~7.8k, the LayerNorm
// 28-35k a block (PERF.md, PR 19). The W stream is not the bound: with no
// reloads of W at all C ran as fast.
//
// What the design does about it:
// - W by TMA. A ring of STAGES stages of BK = 64 rows of k, each stage
//   NB * BN / 64 boxes of 64 columns x 64 rows (one 128-byte swizzle atom
//   wide: 8 KB), zero-filled past K and past ldw. One producer warp (its
//   lane 0) walks the block's tiles and k-stages ahead of the consumers on
//   full/empty mbarriers, so no consumer thread computes an address or
//   waits on a copy of W. Clusters whose blocks share each stage by TMA
//   multicast, which halves W's L2 reads, measured slower on the H100 (C
//   at N = 3072: 2.05 ms with two blocks a cluster, 3.16 with four, 1.31
//   with one), so a block loads its own.
// - The product. Consumer warpgroups (WGS_M x WGS_N, each 64 rows x WN =
//   128 columns, 64 f32 accumulators a thread) issue wgmma m64n128k16, bf16
//   x bf16 -> f32: the row operand K-major from 128-byte-swizzled shared
//   memory, W MN-major (read transposed: 16-bit types allow it), NB wgmma a
//   16-deep k-step in the Plan's order, committed as one group a stage. A
//   stage's wgmma run while the threads prepare the next stage's rows; the
//   stage before is released once its group completed (wgmma.wait_group
//   1), so two stages are in flight (three measured slower).
// - The row operand comes from a Rows policy of the kernel: init() before
//   the first stage; before(j) and after(j) around stage j's wgmma (for a
//   streamed operand: a warpgroup barrier, then the next stage's rows stored
//   from registers and the one after issued to global memory, so its
//   latency hides behind a whole stage of wgmma); desc(j, ks, wm) the
//   descriptor of stage j's 64-row chunk.
// - The epilogue, once per output tile, after the k-loop (on a branch of
//   the loop, ptxas serialized every wgmma): the tile's bias loaded into
//   registers while its last wgmma run (read one column at a time between
//   the stores, the epilogue took twice the tile's k-loop), the
//   accumulators through epi.apply(v, b) (bias, activation) in f32,
//   rounded once to Out, staged warp by warp through shared memory (a
//   16-row slice 128 bytes wide at a time, its row pitch chosen free of
//   bank conflicts) and written with 16-byte stores where the row allows.
//   Where each warpgroup reads its own columns of W (C's), a warpgroup
//   stages in its own columns of the tile's last stage, held back from the
//   producer until the output is out: the staging costs no shared memory
//   of its own, which is C's fourth stage.
// - Registers: the producer is a warp, not a warpgroup, so a block is
//   32 * (4 WGS + 1) threads; at 288 ptxas may give each thread up to 224,
//   well above the 64 accumulators and the rows' registers.
// - The Tiles policy names a block's output tiles in order: a persistent
//   block walks several, and the ring runs on across them, so the next
//   tile's first stages land during this tile's epilogue.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wg {

constexpr int BK = 64;            // k a stage: one 128-byte swizzle row
constexpr int CHUNK = 64 * 128;   // bytes: 64 rows x 64 bf16
constexpr int WN = 128;           // output columns a consumer warpgroup
constexpr int ACC = WN / 2;       // f32 accumulators a thread
constexpr int PITCH = 160;        // bytes a staged output row, at most

// WGS_M x WGS_N consumer warpgroups on a BM x BN tile; NB pieces of W;
// STAGES of the W ring.
template <int WGS_M_, int WGS_N_, int NB_, int STAGES_>
struct Cfg {
  static constexpr int WGS_M = WGS_M_, WGS_N = WGS_N_, NB = NB_;
  static constexpr int STAGES = STAGES_;
  // stage j - STAGES is released at iteration j - STAGES + 1: the load of
  // stage j has STAGES - 2 iterations and the rest of one to land
  static_assert(STAGES >= 3, "a stage loads while two are read");
  static constexpr int BM = 64 * WGS_M, BN = WN * WGS_N;
  static constexpr int CONSUMERS = 128 * WGS_M * WGS_N;
  static constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
  static constexpr int ATOMS = BN / 64;            // boxes a piece a stage
  static constexpr int BOXES = NB * ATOMS;
  static constexpr int STAGE_BYTES = BOXES * CHUNK;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // The epilogue's staging, 16 rows of PITCH bytes a consumer warp: in the
  // tile's last stage where each warpgroup reads W columns of its own
  // (WGS_M = 1), so that a warpgroup stages in its own columns of the stage
  // as soon as its own wgmma are done; else an area of its own, after the
  // ring (every warpgroup reads every column of a stage).
  static constexpr bool RING_STAGING = WGS_M == 1;
  static constexpr int STAGING =
      RING_STAGING ? 0 : (CONSUMERS / 32) * 16 * PITCH;
  static_assert(!RING_STAGING || 4 * 16 * PITCH <= (WN / 64) * CHUNK,
                "a warpgroup's staging fits in its columns of a stage");

  // Shared memory past the kernel's row operand (rows_bytes, a multiple
  // of 1,024 from a 1,024-aligned base): the ring, the staging, the
  // barriers. bytes(): all of it with the base's alignment slack.
  __host__ __device__ static constexpr int bars_at(int rows_bytes) {
    return rows_bytes + RING + STAGING;
  }
  __host__ __device__ static constexpr int bytes(int rows_bytes) {
    return 1024 + bars_at(rows_bytes) + 2 * STAGES * 8;
  }
};

__device__ __forceinline__ char* align_1024(char* p) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~(uintptr_t)1023);
}

// d (+)= A B for 64 rows x 128 columns x 16 k: A K-major and B MN-major
// (imm-trans-b = 1) in shared memory; accumulate unless 0.
__device__ __forceinline__ void wgmma_n128(float (&d)[ACC], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// 16 bf16 (a row's 32 bytes) at k-unit pair (2u, 2u + 1) of row r of a
// 64-row chunk in the 128-byte swizzle.
__device__ __forceinline__ void store_units(char* chunk, int r, int u,
                                            const uint32_t (&h)[8]) {
  char* row = chunk + r * 128;
  *reinterpret_cast<uint4*>(row + (((2 * u) ^ (r & 7)) << 4)) =
      make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(row + (((2 * u + 1) ^ (r & 7)) << 4)) =
      make_uint4(h[4], h[5], h[6], h[7]);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = hop::pack_bf16(a, b);
}

// A consumer warp's 16 rows x WN columns of the tile: row0 and col0 are the
// output coordinates of its first accumulator. The wgmma layout: thread
// (g = lane / 4, c = lane % 4) holds columns 8 n + 2 c, + 1 of rows g (acc
// 4 n, 4 n + 1) and g + 8 (4 n + 2, 4 n + 3); bias[n] is the epilogue's
// bias of that column pair (Epi::bias2), epi.apply(v, b) an output's value.
// Staged 128 bytes of columns at a time with a row pitch of 160 (f32:
// 8-byte stores of the two half-warps hit distinct banks) or 144 bytes
// (bf16: 4-byte stores). vec_out: N * sizeof(Out) is a multiple of 16 and
// out 16-byte aligned.
template <typename Out, class Epi>
__device__ __forceinline__ void store_warp_tile(const float (&acc)[ACC],
                                                const float2 (&bias)[WN / 8],
                                                const Epi& epi, char* st,
                                                Out* out, long long M, int N,
                                                long long row0, int col0,
                                                bool vec_out, int lane) {
  constexpr int SZ = (int)sizeof(Out), EPC = 16 / SZ, PASS = 128 / SZ;
  constexpr int GPP = PASS / 8, PITCH_OUT = SZ == 4 ? 160 : 144;
  static_assert(PITCH_OUT <= PITCH, "the staging's room");
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int q = 0; q < WN / PASS; ++q) {
#pragma unroll
    for (int gg = 0; gg < GPP; ++gg) {
      const int n = q * GPP + gg;
      char* p = st + g * PITCH_OUT + (8 * gg + 2 * c) * SZ;
      store_pair(reinterpret_cast<Out*>(p), epi.apply(acc[4 * n], bias[n].x),
                 epi.apply(acc[4 * n + 1], bias[n].y));
      store_pair(reinterpret_cast<Out*>(p + 8 * PITCH_OUT),
                 epi.apply(acc[4 * n + 2], bias[n].x),
                 epi.apply(acc[4 * n + 3], bias[n].y));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = lane + 32 * i, r = ch >> 3, u = ch & 7;
      const long long m = row0 + r;
      const int n = col0 + q * PASS + u * EPC;
      if (m >= M || n >= N) continue;
      const char* src = st + r * PITCH_OUT + u * 16;
      Out* dst = out + m * N + n;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < EPC && n + e < N; ++e)
          dst[e] = reinterpret_cast<const Out*>(src)[e];
      }
    }
    __syncwarp();
  }
}

// A consumer warp's release of a stage: one arrival on the stage's empty
// barrier, after the warp's wgmma reading it completed.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hop::mbar_arrive(bar);
}

// The producer (one thread): stage j's boxes of W, NB pieces x ATOMS
// columns of 64 for tile j / kt at k-stage j % kt; box b = p ATOMS + a at
// b * CHUNK in the stage.
template <class C, class Tiles>
__device__ __forceinline__ void produce(const Tiles& tiles,
                                        const CUtensorMap* wmap, int kt,
                                        int total, char* ring,
                                        uint64_t* full, uint64_t* empty) {
  long long m0;
  int n0, t = 0, ks = 0;
  if (total > 0) tiles.tile(0, m0, n0);
  for (int j = 0; j < total; ++j) {
    const int s = j % C::STAGES;
    if (j >= C::STAGES) hop::mbar_wait(&empty[s], ((j / C::STAGES) - 1) & 1);
    hop::mbar_expect_tx(&full[s], C::STAGE_BYTES);
    char* dst = ring + s * C::STAGE_BYTES;
    for (int b = 0; b < C::BOXES; ++b) {
      const int p = b / C::ATOMS, a = b - p * C::ATOMS;
      hop::tma_load_3d(dst + b * CHUNK, wmap, &full[s], n0 + 64 * a,
                       ks * BK, p);
    }
    if (++ks == kt) {
      ks = 0;
      if (++t < tiles.count()) tiles.tile(t, m0, n0);
    }
  }
}

// The consumers: every tile's kt stages, then its epilogue. Plan::piece(p)
// is W's piece of product p of a k-step (summed in the order p = 0, 1, ...).
// The epilogue follows the k-loop, after a wait for every wgmma, on no
// branch of its own: with the accumulators read on a branch of the loop,
// ptxas inserted its own waits there and serialized every wgmma.
template <class C, class Plan, class Rows, class Tiles, class Epi,
          typename Out>
__device__ __forceinline__ void consume(Rows& rows, const Tiles& tiles,
                                        int kt, const Epi& epi, Out* out,
                                        long long M, int N, bool vec_out,
                                        char* ring, char* staging,
                                        uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = tid >> 7, wq = warp & 3;
  const int wm = wgi / C::WGS_N, wn = wgi - wm * C::WGS_N;
  rows.init();
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  const int n_tiles = tiles.count();
  for (int t = 0, j = 0; t < n_tiles; ++t) {
    for (int ks = 0; ks < kt; ++ks, ++j) {
      const int s = j % C::STAGES;
      rows.before(j);
      hop::mbar_wait(&full[s], (j / C::STAGES) & 1);
      const uint64_t ad = rows.desc(j, ks, wm);
      const char* bs = ring + s * C::STAGE_BYTES + wn * (WN / 64) * CHUNK;
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < C::NB; ++p)
          wgmma_n128(acc, ad + 2 * kk,
                     hop::smem_desc(bs + Plan::piece(p) * C::ATOMS * CHUNK +
                                        kk * 16 * 128,
                                    CHUNK, 1024),
                     ks | kk | p);
      hop::wg_commit();
      hop::wg_wait<1>();
      // the stage before, now read (a previous tile's last was released
      // after its epilogue)
      if (ks > 0) release(&empty[(j - 1) % C::STAGES], lane);
      rows.after(j);
    }
    // the epilogue's bias (or folded bias) for this thread's columns,
    // loaded while the tile's last wgmma run
    long long m0;
    int n0;
    tiles.tile(t, m0, n0);
    const int col0 = n0 + wn * WN + 2 * (lane & 3);
    float2 bias[WN / 8];
#pragma unroll
    for (int n = 0; n < WN / 8; ++n) bias[n] = epi.bias2(col0 + 8 * n);
    hop::wg_wait<0>();
    hop::reg_fence(acc);
    const int last = (j - 1) % C::STAGES;
    char* st;
    if constexpr (C::RING_STAGING) {
      // the warpgroup's own columns of the tile's last stage, held back
      // from the producer until the output is out
      st = ring + last * C::STAGE_BYTES + wn * (WN / 64) * CHUNK +
           wq * 16 * PITCH;
    } else {
      st = staging + warp * 16 * PITCH;
      release(&empty[last], lane);
    }
    store_warp_tile(acc, bias, epi, st, out, M, N, m0 + wm * 64 + 16 * wq,
                    n0 + wn * WN, vec_out, lane);
    hop::reg_fence(acc);
    if constexpr (C::RING_STAGING) {
      // the staging's generic accesses before TMA writes the stage again
      hop::fence_proxy_async();
      release(&empty[last], lane);
    }
  }
}

// The block's GEMM over its tiles (Tiles: count(), tile(t, m0, n0)) at
// depth K; rows_bytes of shared memory from the aligned base hold the row
// operand (Rows). Every thread of the block calls it.
template <class C, class Plan, class Rows, class Tiles, class Epi,
          typename Out>
__device__ __forceinline__ void gemm(Rows& rows, const Tiles& tiles,
                                     const CUtensorMap* wmap, int K,
                                     const Epi& epi, Out* out, long long M,
                                     int N, bool vec_out, char* smem,
                                     int rows_bytes) {
  char* ring = smem + rows_bytes;
  char* staging = ring + C::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars_at(rows_bytes));
  uint64_t* empty = full + C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], C::CONSUMERS / 32);  // every consumer warp
    }
    hop::fence_mbar_init();
  }
  __syncthreads();
  const int kt = (K + BK - 1) / BK;
  if (threadIdx.x >= C::CONSUMERS) {
    if (threadIdx.x == C::CONSUMERS)
      produce<C>(tiles, wmap, kt, tiles.count() * kt, ring, full, empty);
  } else {
    consume<C, Plan>(rows, tiles, kt, epi, out, M, N, vec_out, ring,
                     staging, full, empty);
  }
}

// Row blocks of BM rows, their column tiles in order: the block's tile t
// is (m0, t * BN).
template <class C>
struct ColumnTiles {
  long long m0;
  int n_tiles;
  __device__ int count() const { return n_tiles; }
  __device__ void tile(int t, long long& m0_, int& n0) const {
    m0_ = m0;
    n0 = t * C::BN;
  }
};

// A persistent block's tiles: st = first, first + stride, ... of the
// grid's tiles, column tiles fastest (so the blocks in flight share their
// rows and W in L2).
template <class C>
struct PersistentTiles {
  int n_nt, n_st, first, stride;
  __device__ int count() const {
    return first < n_st ? (n_st - first + stride - 1) / stride : 0;
  }
  __device__ void tile(int t, long long& m0, int& n0) const {
    const int st = first + t * stride, mt = st / n_nt;
    n0 = (st - mt * n_nt) * C::BN;
    m0 = (long long)mt * C::BM;
  }
};

// ------------------------------------------------------------------- host

// A 3-D map over W's pieces (pieces, K, ldw) bf16 row-major, boxes of 64
// columns x BK rows of one piece in the 128-byte swizzle, zero fill past K
// and ldw. False where the encoder refuses it (ldw * 2 not a multiple of
// 16, or w not 16-byte aligned).
inline bool weight_map(CUtensorMap* map, const void* w, int pieces, int K,
                       int ldw) {
  const hop::EncodeTiled encode = hop::encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ldw, (cuuint64_t)K,
                              (cuuint64_t)pieces};
  const cuuint64_t strides[2] = {(cuuint64_t)ldw * 2,
                                 (cuuint64_t)ldw * 2 * (cuuint64_t)K};
  const cuuint32_t box[3] = {64, BK, 1}, elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches kernel on `grid` blocks of C::THREADS threads with `bytes` of
// dynamic shared memory; returns cudaGetLastError() after the launch.
template <class C, typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), unsigned grid, int bytes,
           cudaStream_t s, Args&&... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::THREADS, bytes, s>>>(static_cast<Args&&>(args)...);
  return (int)cudaGetLastError();
}

// The blocks of `kernel` that fit on the current device at once (a
// persistent grid's size); 0 on an error.
template <class C, typename... KArgs>
int resident_blocks(void (*kernel)(KArgs...), int bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, C::THREADS, (size_t)bytes) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace wg
