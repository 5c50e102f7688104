// One tensor-core GEMM mainloop for Hopper (sm_90a) on mma.sync, shared by
// kernel A's mma.sync variant (csrc/patch_embed.cu) and kernel C's
// (csrc/fused_ln.cu).
//
// Which paths stay on it, by rule (the rest run on the wgmma mainloop of
// csrc/wg_gemm.cuh): kernel C with an f32 W (3xTF32: TF32 wgmma reads only
// K-major operands, so W would need a transposed copy, and the per-k-step
// flush below would need a second accumulator tile) and with a bf16 W past
// the wgmma variant's slab (K > LN_WG_MAX_K, csrc/fused_ln.cuh); kernel A
// and C's bf16 paths when forced (variant "mma"), to measure the two
// mainloops side by side. Kernel A's f32 images run on neither (a CUDA-core
// kernel in patch_embed.cu).
//
// A block computes one BM x BN tile of out = act(A @ W + bias) with
// warp-level mma.sync and f32 accumulators. Each operand may come in
// "pieces" whose products are summed into the one accumulator: a Plan
// lists the (A piece, W piece) products of every k-step. That is how the
// kernels keep f32 accuracy on the tensor cores:
//   - kernel A: uint8 pixels are exact in bf16; the affine is folded into W
//     and W is split into three bf16 pieces (hi, mid, lo: 24 significand
//     bits), so every pixel x piece product is exact (Plan: lo, mid, hi);
//   - kernel C, f32 W: 3xTF32 (y_hi W_lo + y_lo W_hi + y_hi W_hi, each
//     operand rounded to TF32 as cvt.rna rounds: hop::tf32_rna), each
//     k-step's products summed from 0 and added to the accumulator in f32
//     (Plan::FLUSH);
//   - kernel C, bf16 W: one bf16 product, the JAX kernel's own arithmetic.
//
// The pieces:
//   - Op (Bf16Op, Tf32Op): the operand type, the mma shape (m16n8k16 bf16,
//     m16n8k8 tf32), and how fragments come out of shared memory. A stage
//     spans 64 bytes of k (32 bf16 or 16 f32 values) for both.
//   - The W operand (row-major (K, ldw), pieces ldw*K apart, ldw a multiple
//     of 16 bytes, 16-byte aligned) arrives by a ring of STAGES cp.async
//     stages (16-byte copies, zero fill past K and past ldw) into rows
//     padded against bank conflicts.
//   - The A operand comes from a producer functor of the calling kernel:
//     load(k0) issues its global loads for the stage at k0 into registers,
//     store(stage) transforms them in registers and writes the stage's NA
//     pieces to shared memory. The loads of stage k+1 are issued before the
//     mma of stage k and stored after it, so their latency hides behind
//     the tensor cores. Rows of a piece are 64 + 16 bytes apart, so the
//     ldmatrix reads are free of bank conflicts.
//   - An epilogue functor maps an accumulator to its value (bias,
//     activation) once; the tile is rounded once to the output type,
//     staged through shared memory and written with 16-byte stores where
//     the row allows.
//
// The Tile: every warp owns 64 x 32 of the output (64 f32 accumulators a
// thread, which leaves room under 128 registers for the fragments of three
// W pieces, or two A and two W pieces), and an SM holds 16 warps: two
// blocks of 8 on 128 x 128 (kernel A), or one of 16 on 128 x 256 (kernel
// C, whose f32 x is the operand worth sharing). Measured on the H100
// (chip_smoke.py phases 2 and 3b): with 64 x 64 warp tiles (128
// accumulators) and 8 warps an SM, kernel C ran 20-36% slower and kernel
// A no faster, though both re-read less through L2, so warps in flight
// matter more here than L2 traffic. One __syncthreads per stage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"  // tf32_rna

namespace tc {

constexpr int A_LD = 64 + 16;         // bytes per A row in shared memory

// The block tile (BM x BN) and its WARPS_M x WARPS_N warps, each owning a
// WM x WN sub-tile of MT x NT mma tiles (16 x 8).
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int A_PIECE = BM * A_LD;  // bytes of an A piece
  static constexpr int B_LD = BN + 8;        // W row pitch (elements)
  // 16 warps on an SM, so at most 128 registers a thread.
  static constexpr int MIN_BLOCKS = 512 / THREADS;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole mma tiles");
  static_assert(MIN_BLOCKS >= 1, "at most 16 warps");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

using hop::tf32_rna;

// A fragment of one 16-row tile at k-step kk of a stage, for either Op: a
// k-step spans 32 bytes (16 bf16 or 8 f32), and ldmatrix's 8 x 16-byte
// matrices give the m16n8k16 bf16 and the m16n8k8 tf32 A layouts alike.
// Rows 80 bytes apart: the 8 rows of a matrix hit 8 distinct bank groups.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const char* piece,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, piece + (row0 + (lane & 15)) * A_LD + kk * 32 +
                     (lane >> 4) * 16);
}

// bf16 operands, mma.sync m16n8k16, W fragments by ldmatrix.trans; the
// W row pitch (BN + 8 elements) is 16 bytes past a multiple of 128, so the
// 8 rows of a matrix hit 8 distinct bank groups.
struct Bf16Op {
  using T = __nv_bfloat16;
  static constexpr int BK = 32;          // k per stage
  static constexpr int KSTEPS = 2;       // mma k-steps per stage
  static constexpr int EPC = 8;          // elements per 16-byte chunk

  // The fragments of NT n8 tiles from column col0 (W pitch LDB).
  template <int NT, int LDB>
  __device__ static __forceinline__ void load_b(uint32_t (&b)[NT][2],
                                                const T* bs, int kk, int col0,
                                                int lane) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * LDB +
                               col0 + j * 16 + (lane >> 4) * 8);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
  }
  __device__ static __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // d = a * b (a zero accumulator in).
  __device__ static __forceinline__ void mma0(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  }
};

// TF32-valued f32 operands, mma.sync m16n8k8. W fragments are single
// 32-bit loads (ldmatrix.trans moves 16-bit elements); the W row pitch is
// 8 words past a multiple of 32 (BN + 8 with BN a multiple of 64), so the
// (k = lane % 4, n = lane / 4) pattern hits 32 distinct banks.
struct Tf32Op {
  using T = float;
  static constexpr int BK = 16;
  static constexpr int KSTEPS = 2;
  static constexpr int EPC = 4;

  template <int NT, int LDB>
  __device__ static __forceinline__ void load_b(uint32_t (&b)[NT][2],
                                                const T* bs, int kk, int col0,
                                                int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = bs + (kk * 8 + t) * LDB + col0 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = __float_as_uint(p[nt * 8]);
      b[nt][1] = __float_as_uint(p[4 * LDB + nt * 8]);
    }
  }
  __device__ static __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // d = a * b (a zero accumulator in).
  __device__ static __forceinline__ void mma0(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  }
};

// Shared-memory layout of a GEMM with NA A pieces, NB W pieces and STAGES
// W stages: 2 A stages (the producer's double buffer), then the W ring;
// the epilogue reuses it to stage the output tile.
template <class Op, class Tl, int NA, int NB, int STAGES, class Out>
struct Layout {
  static constexpr int A_STAGE = NA * Tl::A_PIECE;
  static constexpr int B_PIECE_ELEMS = Op::BK * Tl::B_LD;
  static constexpr int B_STAGE =
      NB * B_PIECE_ELEMS * (int)sizeof(typename Op::T);
  static constexpr int PIPE = 2 * A_STAGE + STAGES * B_STAGE;
  static constexpr int O_LD = Tl::BN + 16 / (int)sizeof(Out);  // padded
  static constexpr int STAGE_OUT = Tl::BM * O_LD * (int)sizeof(Out);
  static constexpr int BYTES = PIPE > STAGE_OUT ? PIPE : STAGE_OUT;
};

// Copies the W stage at k0 (NB pieces, BK rows x BN columns from n0).
template <class Op, class Tl, int NB>
__device__ __forceinline__ void load_w_stage(char* dst,
                                             const typename Op::T* w,
                                             long long piece_stride, int ldw,
                                             int K, int k0, int n0, int tid) {
  using T = typename Op::T;
  constexpr int CPR = Tl::BN / Op::EPC;  // 16-byte chunks per row
  constexpr int CHUNKS = Op::BK * CPR;
  static_assert(CHUNKS % Tl::THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int p = 0; p < NB; ++p) {
    T* s = reinterpret_cast<T*>(dst) + p * Op::BK * Tl::B_LD;
    const T* g = w + p * piece_stride;
#pragma unroll
    for (int it = 0; it < CHUNKS / Tl::THREADS; ++it) {
      const int i = tid + it * Tl::THREADS;
      const int r = i / CPR, c = i % CPR;
      const int k = k0 + r, n = n0 + c * Op::EPC;
      const bool ok = k < K && n < ldw;
      cp_async16(s + r * Tl::B_LD + c * Op::EPC,
                 ok ? g + (long long)k * ldw + n : g, ok ? 16 : 0);
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The epilogue: epi(v, n) is the output value of accumulator v in column
// n < N; the tile goes through shared memory (rounded once to Out) and
// out row by row. vec_out: N * sizeof(Out) is a multiple of 16 bytes and
// out 16-byte aligned, so every 16-byte chunk that starts before N lies
// within the row.
template <class Tl, class Out, class Epi>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Tl::MT][Tl::NT][4], const Epi& epi, char* smem,
    Out* out, long long M, int N, long long m0, int n0, bool vec_out) {
  constexpr int O_LD = Tl::BN + 16 / (int)sizeof(Out);
  constexpr int EPC = 16 / (int)sizeof(Out);
  constexpr int CPR = Tl::BN / EPC;
  Out* st = reinterpret_cast<Out*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt) {
    const int r = wm * Tl::WM + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < Tl::NT; ++nt) {
      const int c = wn * Tl::WN + nt * 8 + 2 * t;
      const int n = n0 + c;
      const float (&d)[4] = acc[mt][nt];
      store_pair(&st[r * O_LD + c], epi(d[0], n), epi(d[1], n + 1));
      store_pair(&st[(r + 8) * O_LD + c], epi(d[2], n), epi(d[3], n + 1));
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < Tl::BM * CPR; i += Tl::THREADS) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    Out* dst = out + m * N + n;
    const Out* src = &st[r * O_LD + c];
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < EPC && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// The mainloop for the output tile at (m0, n0). Plan: NA, NB, NP and the
// constexpr functions a(p), b(p) naming the pieces of product p, summed in
// the order p = 0, 1, ... (the small products first).
// Per k-step a warp loads the fragments of every W piece once, then those
// of the A pieces one 16-row tile at a time: 64 accumulators + 8 NB + 4 NA
// fragment registers.
template <class Op, class Tl, class Plan, int STAGES, class Out,
          class Producer, class Epi>
__device__ __forceinline__ void gemm_tile(Producer& prod,
                                          const typename Op::T* w,
                                          long long w_piece, int ldw, int K,
                                          const Epi& epi, Out* out,
                                          long long M, int N, long long m0,
                                          int n0, bool vec_out, char* smem) {
  using T = typename Op::T;
  using L = Layout<Op, Tl, Plan::NA, Plan::NB, STAGES, Out>;
  static_assert(STAGES >= 2, "a ring of at least two W stages");
  constexpr int MT = Tl::MT, NT = Tl::NT;
  char* a_base = smem;
  char* b_base = smem + 2 * L::A_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  const int k_tiles = (K + Op::BK - 1) / Op::BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles)
      load_w_stage<Op, Tl, Plan::NB>(b_base + s * L::B_STAGE, w, w_piece,
                                     ldw, K, s * Op::BK, n0, tid);
    cp_async_commit();
  }
  prod.load(0);
  prod.store(a_base);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    // W stage kt has landed and A stage kt is stored, by every thread; the
    // buffers of stage kt - 1 are free.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < k_tiles)
      load_w_stage<Op, Tl, Plan::NB>(b_base + (nk % STAGES) * L::B_STAGE, w,
                                     w_piece, ldw, K, nk * Op::BK, n0, tid);
    cp_async_commit();
    const bool more = kt + 1 < k_tiles;
    if (more) prod.load((kt + 1) * Op::BK);

    const char* as = a_base + (kt & 1) * L::A_STAGE;
    const T* bs =
        reinterpret_cast<const T*>(b_base + (kt % STAGES) * L::B_STAGE);
#pragma unroll
    for (int kk = 0; kk < Op::KSTEPS; ++kk) {
      uint32_t bf[Plan::NB][NT][2];
#pragma unroll
      for (int pb = 0; pb < Plan::NB; ++pb)
        Op::template load_b<NT, Tl::B_LD>(bf[pb], bs + pb * L::B_PIECE_ELEMS,
                                          kk, wn * Tl::WN, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[Plan::NA][4];
#pragma unroll
        for (int pa = 0; pa < Plan::NA; ++pa)
          load_a(af[pa], as + pa * Tl::A_PIECE, wm * Tl::WM + mt * 16, kk,
                 lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (!Plan::FLUSH) {
#pragma unroll
            for (int p = 0; p < Plan::NP; ++p)
              Op::mma(acc[mt][nt], af[Plan::a(p)], bf[Plan::b(p)][nt]);
          } else {
            // The tensor cores add into their accumulator with truncation,
            // so a long chain of mma drifts (3xTF32 at K = 3072: 1152
            // chained adds, ~2e-5 relative). The k-step's products are
            // summed from 0 and added to acc with a rounded f32 add.
            float part[4];
            Op::mma0(part, af[Plan::a(0)], bf[Plan::b(0)][nt]);
#pragma unroll
            for (int p = 1; p < Plan::NP; ++p)
              Op::mma(part, af[Plan::a(p)], bf[Plan::b(p)][nt]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
          }
        }
      }
    }
    if (more) prod.store(a_base + ((kt + 1) & 1) * L::A_STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes the output stage
  store_tile<Tl>(acc, epi, smem, out, M, N, m0, n0, vec_out);
}

// Tile (m0, n0) of a linear grid whose column tiles run fastest: the
// blocks in flight together share their rows of A (read from L2 once
// loaded) and all of W stays in L2.
template <class Tl>
__device__ __forceinline__ void tile_of_block(int N, long long& m0, int& n0) {
  const int n_tiles = (N + Tl::BN - 1) / Tl::BN;
  m0 = (long long)(blockIdx.x / n_tiles) * Tl::BM;
  n0 = (int)(blockIdx.x % n_tiles) * Tl::BN;
}

template <class Tl>
unsigned grid_of(long long M, int N) {
  return (unsigned)(((M + Tl::BM - 1) / Tl::BM) *
                    ((N + Tl::BN - 1) / Tl::BN));
}

// Launches kernel on the grid of an M x N output with `bytes` of dynamic
// shared memory (above 48 KB only after cudaFuncSetAttribute, for the
// current device).
template <class Tl, typename Kernel, typename... Args>
int launch(Kernel kernel, long long M, int N, int bytes, cudaStream_t s,
           Args... args) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid_of<Tl>(M, N), Tl::THREADS, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tc
