// Multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces: vit_research_tpu/ops/attention.py::_attn_kernel (driven by
// _pallas_attention_fwd_impl, public entry multi_head_attention).
//
// Computes o = softmax(q k^T * scale) v per (batch, head) with an f32
// online softmax and f32 accumulation; o is written in the input dtype.
// f32 keeps f32 scores. bf16 forms its scores as the JAX package's bf16
// attention (xla_attention, the einsum path of models/vit.py) does: q k^T
// rounded to bf16, times bf16(scale) rounded, plus bf16(bias) rounded.
// q, k and v are (B, H, T, dh) views with any batch, head and token
// strides (the last dim has stride 1), so the backbone passes the q/k/v
// projections in their (B, T, H, dh) order without a copy; o is written
// through its own strides (the wrapper allocates it (B, T, H, dh)). Any T;
// dh in {16, 32, 64, 96, 128, 192} (96: the stage-1 chunk encoder, 768
// wide with 8 heads, at T = 9 to 25; 128: 768 wide with 6 heads or 1,024
// with 8; 192: the RAG/RATT heads, 768 wide with 4 heads, at T = 5; a
// 64-row query tile is then mostly idle, so f32 there takes
// attn_f32_short). The wrapper runs a width
// between two of these zero-padded to the next (ops/attention.py).
//
// Optional key bias (ToMe's proportional attention, models/vit.py's
// ToMeEncoderBlock): a (B, T) f32 row per batch element, with its batch
// stride, added to every query's scores, softmax(q k^T * scale + bias) v
// (the JAX package adds log(sizes) to the scores on its XLA path). Each
// key tile's 64 bias values are staged in shared memory beside the K/V
// tiles: f32 in log2 units, which the score loop adds with the scale in
// one FMA a score; bf16 rounded to bf16 in natural units, added to the
// bf16 scores as the reference adds log_size.astype(s.dtype). The bias
// must be finite. The kernels are templated on it: without a bias they
// are the unbiased kernels.
//
// What bounds it on the H100 at ViT-B/16 (T = 197, dh = 64): in bf16 the
// bytes (q, k, v read once, o written once: 0.09 ms at B = 256) against
// 0.03 ms of tensor-core operations; the kernel itself is bound by its
// per-score work around the tensor cores (the reference's bf16 roundings,
// the exp, the shared-memory traffic of ldmatrix and of the held scores)
// and by the latency a few warps an SM cannot hide. In f32 on the CUDA
// cores the operations (4*T*T*dh per head at 67 TFLOP/s: 0.46 ms), since
// the parity setting keeps full f32 products (no plain TF32); at dh = 64
// launch_f32 routes f32 to attn_f32_wg instead (csrc/attention_f32_wg.cu:
// TF32 wgmma on split operands, f32 accuracy on the tensor cores, bound by
// the bytes and three TF32 passes: 0.185 ms each), and attn_f32<64> stays
// to be forced beside it (SIMT); at dh = 96, 128 and 192 up to 32 keys
// launch_f32 routes f32 to attn_f32_short (csrc/attention_short.cu: a
// warp a head, bulk copies, bound by the bytes), and attn_f32<DH> stays
// to be forced beside it (SIMT). At T <= 25 (the heads,
// the chunk encoder at B = 1 to 32) a call's host work outlasts its
// kernel: the wrapper (ops/attention.py::_launch) takes the strides in
// one pass, enters a device context only for another device, and this
// entry sets each kernel's shared-memory attribute once per device.
//
// What the design does about it. Both kernels: one block owns 64 query
// rows of one (b, h); K/V stream through shared memory in tiles of 64 keys,
// double-buffered by 16-byte cp.async copies (zero fill past T), so the
// next tile loads while this one is computed; the score matrix never
// leaves the chip and T has no limit (the TPU kernel kept all of K/V in
// VMEM). The grid runs the query blocks of one (b, h) next to each other,
// so their K/V re-reads hit L2. A key tile that runs past T computes only
// its live key groups.
//
// - bf16 (attn_bf16): FlashAttention-2 on the tensor cores. 4 warps x 16
//   query rows; each warp keeps its Q fragment in registers for the whole
//   key loop, forms S = Q K^T with mma.sync m16n8k16 (bf16 in, f32
//   accumulate; K fragments by ldmatrix), rounds S to bf16 as above (two
//   scores an instruction: cvt.rn.bf16x2.f32, then mul.rn.bf16x2 by the
//   scale and add.rn.bf16x2 of the bias, each rounding as the reference's
//   bf16 product and sum do), takes the softmax in f32 with the reference
//   softmax's arithmetic (expf of s - max, the row's sum against its final
//   max in that softmax's order, a correctly rounded quotient: see
//   quotient and RowSums in attention_bf16.cuh), rounds P to bf16 in
//   registers and reuses the S accumulator layout as the A fragment of P V
//   (V fragments by ldmatrix.trans). Rounding S and P to bf16 is what the
//   JAX package does off the TPU (xla_attention's bf16 einsums, and the
//   probabilities cast to the input dtype); its Pallas kernel keeps both
//   in f32. P is the
//   normalised exp(s - max) / sum, rounded as the reference rounds it, so O
//   needs no division. Where one key tile holds the row (T <= 64: the
//   heads, the chunk encoder) that takes one pass. Over several tiles a
//   streaming pass knows the max and the sum only at its end. The held
//   variant (attn_bf16_held, T > 64 up to HeldLayout::MAX_TILES key tiles:
//   T <= 704 at dh = 64) streams K once for the rows' max and holds the
//   rounded scores in shared memory as the bf16 values they are, each
//   thread its own accumulator fragments (2 bytes a score: 8 KB a 64-key
//   tile of a block; the Q tile passes through the K/V ring, so at T = 197
//   a block takes 51,200 bytes and four share an SM); each thread then
//   sums the exps of its held scores against the final max, and V streams
//   once through the same ring, each held score's exp giving P and P V:
//   one q k^T, K and V read once, two exps a score. Holding f32 exps
//   instead (one exp a score, 4 bytes) measured slower: fewer blocks an
//   SM. Past the limit the two-pass kernel (attn_bf16<DH, BIAS, true>)
//   takes the statistics in a first pass that streams K for each row's max
//   and again for its sum (S and its roundings, no P V), and then streams K
//   and V for the same scores, P and P V; both variants take the same
//   arithmetic in the same order, so they give the same bits. At dh = 64
//   and 64 < T <= 256 (the backbone, ToMe's blocks) launch_bf16_with routes
//   to attn_bf16_wg instead (csrc/attention_wg.cu: wgmma and TMA, the whole
//   score row in registers, one exp a score); it gives the held variant's
//   bits too, and the held variant stays to be forced beside it. O is staged
//   through shared memory (the warp's own Q rows; the held variant's ring)
//   and written with 16-byte stores. A warp whose 16 rows all lie past T
//   skips the math but takes part in the copies and barriers. Rows are
//   padded by 16 bytes in shared memory so that ldmatrix reads are free of
//   bank conflicts.
// - f32 (attn_f32; at dh = 64, and at dh = 96, 128 and 192 up to 32 keys,
//   only when forced: launch_f32 routes those shapes to attn_f32_wg and
//   to attn_f32_short, csrc/attention_short.cu, a warp a head):
//   register-tiled on the CUDA cores. 128 threads; thread
//   (ty, tx) owns rows ty + 16i (i < 4) and keys tx + 8j (j < 8) of the
//   64 x 64 score tile, and the same rows x dh/8 columns of O. Q and K sit
//   in shared memory in their natural (row, dh) layout (cp.async copies 16
//   bytes as they lie, it cannot transpose), padded by 16 bytes a row, and
//   the products run 4 deep along dh: per 4 dh steps a thread reads 4 Q and
//   8 K float4 for 128 FMAs, the ratio of a dh x rows transposed staging.
//   Row max and sum come from shuffles across the 8 threads of a row; P
//   goes through a 64 x 72 f32 tile in shared memory (written and read
//   only by the warp that owns its rows) into the P V micro-GEMM, which
//   reads 4 P and dh/8 V float4 per 4 keys for another 128 FMAs.
//   At dh = 192 that layout (64 query rows, K/V double-buffered) needs
//   267,264 bytes of shared memory, over the 232,448 a block may opt into.
//   There a block owns 32 query rows (thread (ty, tx) rows ty + 16i, i <
//   2, so O stays 2 x 24 registers a thread, as 4 x 12 at dh = 96) and K/V
//   are single-buffered: (32*196 + 64*196 + 64*192 + 32*72) * 4 = 133,632
//   bytes (133,888 with the bias), one block an SM. The next key tile then
//   loads only after this one is consumed; on the heads' path T = 5, one
//   tile, so there is nothing to overlap.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bf16.cuh"
#include "hopper.cuh"

// attn_f32_wg (csrc/attention_f32_wg.cu) at dh = 64, any seq, with the
// arguments of vrt_attention_fwd; returns a cudaError_t.
int attention_f32_wg_launch(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int seq,
                            const long long* strides, float scale,
                            const float* bias, long long bias_stride,
                            cudaStream_t stream);
// attn_f32_short (csrc/attention_short.cu) at dh = 96, 128 or 192 and seq
// <= 32, with the arguments of vrt_attention_fwd; returns a cudaError_t.
int attention_f32_short_launch(const void* q, const void* k, const void* v,
                               void* o, int batch, int heads, int seq, int dh,
                               const long long* strides, float scale,
                               const float* bias, long long bias_stride,
                               cudaStream_t stream);

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, t;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides sq, sk, sv, so;
  const float* bias;  // (batch, seq) key bias or null
  long long sbias;    // its batch stride (elements)
  int heads, seq, n_qblocks;
  float scale;       // the caller's (bf16 rounds it to bf16)
  float scale_log2;  // scale * log2(e), f32
};

// 2^x in one SFU instruction (ex2.approx: relative error ~2^-22; 2^-inf =
// 0; results below 2^-126 flush to 0, which a softmax sum >= 1 cannot
// feel). The f32 kernel's exp, in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// Copies ROWS rows of DH elements of (b, h)'s tensor, from token `row0`
// on, into shared memory with row pitch `ld`; rows past `seq` are zeroed.
template <typename T, int DH, int ROWS = 64>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long st, int row0, int seq,
                                          int tid) {
  constexpr int CH = DH * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int PER = 16 / (int)sizeof(T);     // elements per chunk
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    const bool ok = row < seq;
    cp_async16(dst + r * ld + c * PER,
               src + (ok ? (long long)row * st + c * PER : 0), ok ? 16 : 0);
  }
}

// The block's (b, h) pointers and its first query row q0 (blocks of ROWS
// query rows).
template <int ROWS, typename T>
__device__ __forceinline__ void head_ptrs(const Params<T>& p, int& q0,
                                          const T*& qg, const T*& kg,
                                          const T*& vg, T*& og,
                                          const float*& bg) {
  const long long bh = blockIdx.x / p.n_qblocks;
  q0 = (int)(blockIdx.x - bh * p.n_qblocks) * ROWS;
  const long long b = bh / p.heads, h = bh - (bh / p.heads) * p.heads;
  qg = p.q + b * p.sq.b + h * p.sq.h;
  kg = p.k + b * p.sk.b + h * p.sk.h;
  vg = p.v + b * p.sv.b + h * p.sv.h;
  og = p.o + b * p.so.b + h * p.so.h;
  bg = p.bias ? p.bias + b * p.sbias : nullptr;  // read by BIAS kernels
}

// The key bias of keys row0 .. row0 + 63 into dst (0 past seq: those
// scores become -inf): in log2 units for f32, rounded to bf16 for bf16.
// Plain stores by the first 64 threads; the __syncthreads that publishes
// the tile's cp.async copies publishes them too.
__device__ __forceinline__ void load_bias(float* dst, const float* bg,
                                          int row0, int seq, int tid) {
  if (tid < BK) {
    const int j = row0 + tid;
    dst[tid] = j < seq ? bg[j] * LOG2E : 0.f;
  }
}
__device__ __forceinline__ void load_bias(__nv_bfloat16* dst,
                                          const float* bg, int row0, int seq,
                                          int tid) {
  if (tid < BK) {
    const int j = row0 + tid;
    dst[tid] = __float2bfloat16_rn(j < seq ? bg[j] : 0.f);
  }
}

// ---------------------------------------------------------------- bf16

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
// d += a * b for one 16x8x16 tile: bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
struct Bf16Layout {
  static constexpr int LD = DH + 8;  // padded row pitch (elements)
  static constexpr int K = BQ * LD;          // Q tile, then 2 K tiles
  static constexpr int V = K + 2 * BK * LD;  // 2 V tiles
  static constexpr int BYTES = (V + 2 * BK * LD) * 2;
  // 2 key-bias tiles (bf16) after the V tiles, for the BIAS kernel
  static constexpr int BIAS_BYTES = BYTES + 2 * BK * 2;
};

// The shared memory a block may opt into on the H100.
constexpr int MAX_SMEM = 232448;

// The shared memory of two blocks an SM: the SM's 233,472 bytes less the
// 1,024 the runtime keeps for each block, halved.
constexpr int TWO_BLOCKS_SMEM = (233472 - 2 * 1024) / 2;

// attn_bf16_held's shared memory: a ring of two key tiles that holds the Q
// tile and K tile 0 first, then K in the first stream and V in the second,
// the key-bias tiles (BIAS), then the held scores, 64 rows x 64 keys of
// bf16 a tile. The variant takes T while two blocks share an SM (dh <= 96;
// past that, with one block an SM, it lost to the two-pass kernel on the
// H100) and wherever it fits at dh >= 128 (there the two-pass kernel holds
// 254-255 registers and itself runs two blocks an SM or one).
template <int DH, bool BIAS>
struct HeldLayout {
  static constexpr int LD = DH + 8;
  static constexpr int BIAS_AT = 2 * BK * LD * 2;  // bytes
  static constexpr int HELD_AT = BIAS_AT + (BIAS ? 2 * BK * 2 : 0);
  static constexpr int TILE_BYTES = BQ * BK * 2;
  static constexpr int MAX_BYTES = DH >= 128 ? MAX_SMEM : TWO_BLOCKS_SMEM;
  // the most key tiles it takes: T <= 64 * MAX_TILES
  static constexpr int MAX_TILES = (MAX_BYTES - HELD_AT) / TILE_BYTES;
  static constexpr int bytes(int n_tiles) {
    return HELD_AT + n_tiles * TILE_BYTES;
  }
};
// The limits (ops/attention.py::held_max_tiles computes the same;
// tests/test_torch_attention_launch.py pins both).
static_assert(HeldLayout<16, false>::MAX_TILES == 13 &&
                  HeldLayout<16, true>::MAX_TILES == 13,
              "dh = 16: T <= 832");
static_assert(HeldLayout<32, false>::MAX_TILES == 12 &&
                  HeldLayout<32, true>::MAX_TILES == 12,
              "dh = 32: T <= 768");
static_assert(HeldLayout<64, false>::MAX_TILES == 11 &&
                  HeldLayout<64, true>::MAX_TILES == 11,
              "dh = 64: T <= 704");
static_assert(HeldLayout<96, false>::MAX_TILES == 10 &&
                  HeldLayout<96, true>::MAX_TILES == 10,
              "dh = 96: T <= 640");
static_assert(HeldLayout<128, false>::MAX_TILES == 24 &&
                  HeldLayout<128, true>::MAX_TILES == 24,
              "dh = 128: T <= 1536");
static_assert(HeldLayout<192, false>::MAX_TILES == 22 &&
                  HeldLayout<192, true>::MAX_TILES == 22,
              "dh = 192: T <= 1408");

// One warp's S for one key tile (keys j0 .. j0 + 63 in kt, their bias in
// bt): S = Q K^T over 8 key groups of 8 on mma.sync (groups of 16 keys
// wholly past T are skipped), then rounded as the reference rounds its
// bf16 scores, bf16(bf16(bf16(q k^T) * bf16(scale)) + bf16(bias)), two
// adjacent keys at a time; keys >= T: -inf. s[n][e]: row g = lane / 4 (e <
// 2) or g + 8, key n * 8 + (lane % 4) * 2 + e % 2, the mma accumulator
// layout.
template <int DH, bool BIAS>
__device__ __forceinline__ void bf16_scores(
    float (&s)[8][4], const uint32_t (&qf)[DH / 16][4],
    const __nv_bfloat16* kt, const __nv_bfloat16* bt, int j0, int seq,
    uint32_t scale2, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * np][e] = s[2 * np + 1][e] = 0.f;
    if (j0 + np * 16 < seq) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, &kt[(np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
  }
  auto rounded = [&](float& x0, float& x1, int col) {
    round_scores<BIAS>(x0, x1, scale2,
                       BIAS ? *reinterpret_cast<const uint32_t*>(&bt[col])
                            : 0u);
  };
  if (j0 + BK <= seq) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        rounded(s[n][e], s[n][e + 1], n * 8 + (lane & 3) * 2);
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int col = n * 8 + (lane & 3) * 2;
        rounded(s[n][e], s[n][e + 1], col);
        if (j0 + col >= seq) s[n][e] = -CUDART_INF_F;
        if (j0 + col + 1 >= seq) s[n][e + 1] = -CUDART_INF_F;
      }
  }
}

// The warp's output rows, staged through its own 16 Q rows in shared
// memory (free once the key loop is done) and written in 16-byte chunks.
template <int DH>
__device__ __forceinline__ void store_o_bf16(const float (&o)[DH / 8][4],
                                             __nv_bfloat16* stage,
                                             __nv_bfloat16* og, long long st,
                                             int row0, int seq, int lane) {
  constexpr int LD = DH + 8;
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(&stage[g * LD + col]) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(&stage[(g + 8) * LD + col]) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  constexpr int CH = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const int row = row0 + r;
    if (row < seq)
      *reinterpret_cast<uint4*>(og + (long long)row * st + c * 8) =
          *reinterpret_cast<const uint4*>(&stage[r * LD + c * 8]);
  }
}

// O += P V for the live 16-key groups of one key tile: P (bf16) as the A
// fragments a[kk] (the S accumulators of key groups 2kk and 2kk + 1), V
// fragments by ldmatrix.trans from vt.
template <int DH>
__device__ __forceinline__ void pv_step(float (&o)[DH / 8][4],
                                        const uint32_t (&a)[4],
                                        const __nv_bfloat16* vt, int kk,
                                        int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &vt[(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 LD +
                             dp * 16 + (lane >> 4) * 8]);
    mma_bf16(o[2 * dp], a, b[0], b[1]);
    mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
  }
}

// The row max of one key tile's scores for rows g (mx0) and g + 8 (mx1),
// across the row's four threads; finite: every tile holds a key < T.
__device__ __forceinline__ void tile_max(const float (&s)[8][4], float& mx0,
                                         float& mx1) {
  mx0 = mx1 = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
}

// s = exp(s - max) in place, rows g (m0) and g + 8 (m1). s - max of two
// bf16 values rounds as the reference's f32 difference does; keys >= T
// (-inf) give 0.
__device__ __forceinline__ void tile_exps(float (&s)[8][4], float m0,
                                          float m1) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = expf(s[n][0] - m0);
    s[n][1] = expf(s[n][1] - m0);
    s[n][2] = expf(s[n][2] - m1);
    s[n][3] = expf(s[n][3] - m1);
  }
}

// A tile's exps into the rows' sums, in the reference's order.
__device__ __forceinline__ void tile_sums(RowSums& r, const float (&e)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) row_add(r, n, e[n][0], e[n][1], e[n][2], e[n][3]);
}

// O += P V for the live 16-key groups of one key tile from its exps e: P =
// bf16(e / l) (rows g: l0 and r0 = 1 / l0; g + 8: l1, r1), the exps of key
// groups 2kk and 2kk + 1 forming the A fragment of one 16-key step.
template <int DH, bool SAFE>
__device__ __forceinline__ void pv_tile(float (&o)[DH / 8][4],
                                        const float (&e)[8][4], float l0,
                                        float r0, float l1, float r1,
                                        const __nv_bfloat16* vt, int j0,
                                        int seq, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (j0 + kk * 16 < seq) {
      const float ek[8] = {e[2 * kk][0],     e[2 * kk][1],
                           e[2 * kk][2],     e[2 * kk][3],
                           e[2 * kk + 1][0], e[2 * kk + 1][1],
                           e[2 * kk + 1][2], e[2 * kk + 1][3]};
      uint32_t a[4];
      p_frag<SAFE>(a, ek, l0, r0, l1, r1);
      pv_step<DH>(o, a, vt, kk, lane);
    }
  }
}

// One key tile (T <= 64): S, the rows' max, exps and sums, P and O += P V in
// one pass. TWO_PASS (T > 64, past the held variant's reach): P needs the
// row's sum against its final max before its first P V, so a first pass
// takes the statistics, streaming K for each row's max and K again for the
// sums against it, and a second streams K and V for the same scores, P and
// P V. Every stream forms S anew; the held variant holds it instead.
template <int DH, bool BIAS, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS)
attn_bf16(const Params<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  using L = Bf16Layout<DH>;
  constexpr int LD = L::LD;
  constexpr int KSTEPS = DH / 16;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);
  auto Ks = [&](int buf) { return Qs + L::K + buf * BK * LD; };
  auto Vs = [&](int buf) { return Qs + L::V + buf * BK * LD; };
  bf16* Bs = Qs + L::BYTES / 2;  // [2][BK] if BIAS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int q0;
  const bf16 *qg, *kg, *vg;
  bf16* og;
  const float* bg;
  head_ptrs<BQ>(p, q0, qg, kg, vg, og, bg);
  const int seq = p.seq;
  const int n_tiles = TWO_PASS ? (seq + BK - 1) / BK : 1;
  const bool active = q0 + warp * 16 < seq;
  const uint32_t scale2 = pack_bf16(p.scale, p.scale);  // bf16(scale) x 2
  uint32_t qf[KSTEPS][4];

  // Stages the K tile (and with with_v the V tile) of keys from row0 into
  // buffer buf, with its key-bias tile.
  auto load_tile = [&](int buf, int row0, bool with_v) {
    load_rows<bf16, DH>(Ks(buf), LD, kg, p.sk.t, row0, seq, tid);
    if (with_v) load_rows<bf16, DH>(Vs(buf), LD, vg, p.sv.t, row0, seq, tid);
    cp_async_commit();
    if constexpr (BIAS) load_bias(Bs + buf * BK, bg, row0, seq, tid);
  };
  // Streams the key tiles (with their V tiles: with_v) through the two
  // buffers and calls body(s, j0, buf) for the warp's rows on each, s the
  // tile's scores as the reference rounds them (keys >= T: -inf). The Q
  // tile arrives with the first stream's first tile (first).
  auto stream = [&](bool with_v, bool first, auto&& body) {
    load_tile(0, 0, with_v);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < n_tiles) {
        load_tile(buf ^ 1, (tile + 1) * BK, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        if (first && tile == 0) {
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk)
            ldmatrix_x4(qf[kk], &Qs[(warp * 16 + (lane & 15)) * LD +
                                    kk * 16 + (lane >> 4) * 8]);
        }
        float s[8][4];
        bf16_scores<DH, BIAS>(s, qf, Ks(buf), Bs + buf * BK, tile * BK, seq,
                              scale2, lane);
        body(s, tile * BK, buf);
      }
      __syncthreads();  // this buffer is refilled next iteration
    }
  };

  load_rows<bf16, DH>(Qs, LD, qg, p.sq.t, q0, seq, tid);  // with tile 0
  // rows g = lane / 4 and g + 8 of the warp's 16: max (the same in the 4
  // threads of a row), sum and 1 / sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.f, l1 = 0.f, r0 = 0.f, r1 = 0.f;
  bool safe = false;  // a tiny exp in the block (two passes: known ahead)
  if constexpr (TWO_PASS) {
    stream(false, true, [&](float (&s)[8][4], int, int) {
      float mx0, mx1;
      tile_max(s, mx0, mx1);
      m0 = fmaxf(m0, mx0);
      m1 = fmaxf(m1, mx1);
    });
    RowSums sums;
    row_zero(sums);
    uint32_t tiny = ~0u;
    stream(false, false, [&](float (&s)[8][4], int, int) {
      tile_exps(s, m0, m1);
      tile_sums(sums, s);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tiny = tiny_exp(tiny, s[n][e]);
    });
    l0 = row_total(sums.v[0]);  // 0 in a warp past T (never used)
    l1 = row_total(sums.v[1]);
    r0 = __frcp_rn(l0);
    r1 = __frcp_rn(l1);
    safe = __syncthreads_or(has_tiny_exp(tiny));
  }

  float o[DH / 8][4] = {};
  // The P V stream, with the IEEE fallback (SAFE) or without.
  auto pv_stream = [&](auto safe_t) {
    stream(true, !TWO_PASS, [&](float (&s)[8][4], int j0, int buf) {
      if constexpr (!TWO_PASS) {
        tile_max(s, m0, m1);
        tile_exps(s, m0, m1);
        RowSums sums;
        row_zero(sums);
        tile_sums(sums, s);
        l0 = row_total(sums.v[0]);
        l1 = row_total(sums.v[1]);
        r0 = __frcp_rn(l0);
        r1 = __frcp_rn(l1);
      } else {
        tile_exps(s, m0, m1);
      }
      pv_tile<DH, decltype(safe_t)::value>(o, s, l0, r0, l1, r1, Vs(buf), j0,
                                           seq, lane);
    });
  };
  // one pass meets its exps with P: SAFE, a branch for each eight
  if (!TWO_PASS || safe)  // the same in every thread of the block
    pv_stream(std::true_type{});
  else
    pv_stream(std::false_type{});

  if (!active) return;
  store_o_bf16<DH>(o, &Qs[warp * 16 * LD], og, p.so.t, q0 + warp * 16, seq,
                   lane);
}

// The held variant: T > 64 up to HeldLayout::MAX_TILES key tiles. One
// stream of K forms S and rounds it (bf16_scores), takes the rows' max and
// holds the rounded scores in shared memory as the bf16 values they are (2
// bytes a score, exact), each thread its own accumulator fragments, so
// holding them adds no transpose and no barrier. Then each thread reads its
// held scores back for their exps against the final max and the rows' sums
// (while the first two V tiles load), and one stream of V through the same
// ring reads them again for the exps, P = bf16(exp / sum) and O += P V.
// q k^T is formed once and K and V are read once, for two exps a score; the
// arithmetic is the two-pass kernel's, in its order, so the two give the
// same bits.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_bf16_held(const Params<__nv_bfloat16> p) {
  using bf16 = __nv_bfloat16;
  using L = HeldLayout<DH, BIAS>;
  constexpr int LD = L::LD;
  extern __shared__ float4 smem_f4[];
  bf16* ring = reinterpret_cast<bf16*>(smem_f4);
  auto Rs = [&](int buf) { return ring + buf * BK * LD; };
  bf16* Bs = ring + L::BIAS_AT / 2;  // [2][BK] if BIAS
  // held scores, thread-major: key groups 2kk and 2kk + 1 of a tile (rows
  // g and g + 8) as one uint4 of bf16 pairs
  uint4* Hs = reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem_f4) +
                                       L::HELD_AT);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int q0;
  const bf16 *qg, *kg, *vg;
  bf16* og;
  const float* bg;
  head_ptrs<BQ>(p, q0, qg, kg, vg, og, bg);
  const int seq = p.seq;
  const int n_tiles = (seq + BK - 1) / BK;
  auto load_ring = [&](int buf, const bf16* src, long long st, int row0) {
    load_rows<bf16, DH>(Rs(buf), LD, src, st, row0, seq, tid);
    cp_async_commit();
  };

  // the Q tile in ring buffer 1 beside K tile 0, into registers before
  // K tile 1 takes its place
  load_rows<bf16, DH>(Rs(1), LD, qg, p.sq.t, q0, seq, tid);
  load_ring(0, kg, p.sk.t, 0);
  if constexpr (BIAS) load_bias(Bs, bg, 0, seq, tid);

  const bool active = q0 + warp * 16 < seq;
  const uint32_t scale2 = pack_bf16(p.scale, p.scale);  // bf16(scale) x 2
  // rows g = lane / 4 and g + 8 of the warp's 16: the max (the same in the
  // 4 threads of a row)
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;

  // 1. the K stream: S, the rows' max, the held scores
  {
    uint32_t qf[DH / 16][4];
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], &Rs(1)[(warp * 16 + (lane & 15)) * LD + kk * 16 +
                                   (lane >> 4) * 8]);
    }
    __syncthreads();  // ring buffer 1 takes K tile 1 next
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < n_tiles) {
        load_ring(buf ^ 1, kg, p.sk.t, (tile + 1) * BK);
        if constexpr (BIAS)
          load_bias(Bs + (buf ^ 1) * BK, bg, (tile + 1) * BK, seq, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        float s[8][4];
        bf16_scores<DH, BIAS>(s, qf, Rs(buf), Bs + buf * BK, tile * BK, seq,
                              scale2, lane);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Hs[(tile * 4 + kk) * THREADS + tid] = make_uint4(
              pack_bf16(s[2 * kk][0], s[2 * kk][1]),
              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]));
        float mx0, mx1;
        tile_max(s, mx0, mx1);
        m0 = fmaxf(m0, mx0);
        m1 = fmaxf(m1, mx1);
      }
      __syncthreads();  // this buffer is refilled next iteration
    }
  }

  // The ring is free: the first two V tiles load while the sums are formed.
  load_ring(0, vg, p.sv.t, 0);
  if (n_tiles > 1) load_ring(1, vg, p.sv.t, BK);
  // 2. the rows' sums against the final max, from the thread's own held
  // scores, in the reference's order (RowSums); groups of 16 keys past T
  // would add 0
  // the eight exps of one held uint4, in p_frag's order
  auto held_exps = [&](float (&e)[8], const uint4& h) {
    const uint32_t x[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m = j & 1 ? m1 : m0;
      e[2 * j] = expf(lo_bf16(x[j]) - m);
      e[2 * j + 1] = expf(hi_bf16(x[j]) - m);
    }
  };
  float l0, l1;
  bool safe;
  {
    RowSums sums;
    row_zero(sums);
    uint32_t tiny = ~0u;
    if (active) {
      for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (tile * BK + kk * 16 >= seq) continue;
          float e[8];
          held_exps(e, Hs[(tile * 4 + kk) * THREADS + tid]);
          row_add(sums, 2 * kk, e[0], e[1], e[2], e[3]);
          row_add(sums, 2 * kk + 1, e[4], e[5], e[6], e[7]);
#pragma unroll
          for (int i = 0; i < 8; ++i) tiny = tiny_exp(tiny, e[i]);
        }
      }
    }
    l0 = row_total(sums.v[0]);  // 0 in a warp past T (never used)
    l1 = row_total(sums.v[1]);
    safe = __syncthreads_or(has_tiny_exp(tiny));
  }
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

  // 3. the V stream: O += P V, with the IEEE fallback (SAFE) or without
  float o[DH / 8][4] = {};
  auto v_stream = [&](auto safe_t) {
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < n_tiles)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (tile * BK + kk * 16 >= seq) continue;
          float e[8];
          held_exps(e, Hs[(tile * 4 + kk) * THREADS + tid]);
          uint32_t a[4];
          p_frag<decltype(safe_t)::value>(a, e, l0, r0, l1, r1);
          pv_step<DH>(o, a, Rs(buf), kk, lane);
        }
      }
      __syncthreads();  // this buffer is refilled below
      if (tile + 2 < n_tiles) load_ring(buf, vg, p.sv.t, (tile + 2) * BK);
    }
  };
  if (safe)  // the same in every thread of the block
    v_stream(std::true_type{});
  else
    v_stream(std::false_type{});

  // the ring is free (the last tile's barrier): O staged in the warp's 16
  // rows of buffer 0
  if (!active) return;
  store_o_bf16<DH>(o, &Rs(0)[warp * 16 * LD], og, p.so.t, q0 + warp * 16, seq,
                   lane);
}

// ----------------------------------------------------------------- f32

// dh <= 128: 64 query rows, K/V double-buffered. dh = 96: (64*100 +
// 2*64*100 + 2*64*96 + 64*72) * 4 = 144,384 bytes (plus 512 with the
// bias), one block an SM. dh = 128: (64*132 + 2*64*132 + 2*64*128 +
// 64*72) * 4 = 185,344 bytes (plus 512), one block an SM; O is 4 x 16
// registers a thread. dh = 192: 32 query rows, one K/V buffer:
// (32*196 + 64*196 + 64*192 + 32*72) * 4 = 133,632 bytes (plus 256 with
// the bias), one block an SM. Both under the 232,448 a block may opt into.
template <int DH>
struct F32Layout {
  // the 64-row, double-buffered layout while it fits in 232,448 bytes
  static constexpr int ROWS = DH > 128 ? 32 : 64;  // query rows a block
  static constexpr int RI = ROWS / 16;  // query rows a thread, 16 apart
  static constexpr int STAGES = DH > 128 ? 1 : 2;  // K/V buffers
  static constexpr int LDQ = DH + 4, LDK = DH + 4, LDV = DH, LDP = BK + 8;
  static constexpr int Q = 0;
  static constexpr int K = Q + ROWS * LDQ;
  static constexpr int V = K + STAGES * BK * LDK;
  static constexpr int P = V + STAGES * BK * LDV;
  static constexpr int FLOATS = P + ROWS * LDP;
  static constexpr int BYTES = FLOATS * 4;
  // a key-bias tile for each K/V buffer after P, for the BIAS kernel
  static constexpr int BIAS_BYTES = BYTES + STAGES * BK * 4;
};
static_assert(F32Layout<96>::BYTES == 144384, "dh = 96 layout");
static_assert(F32Layout<128>::BYTES == 185344, "dh = 128 layout");
static_assert(F32Layout<192>::BYTES == 133632, "dh = 192 layout");
static_assert(Bf16Layout<128>::BYTES == 87040, "bf16 dh = 128 layout");
static_assert(Bf16Layout<192>::BYTES == 128000, "bf16 dh = 192 layout");

// O columns of thread tx: dh/8 of them, as float4 groups 32 apart (dh >=
// 32) or one float2 (dh = 16).
template <int DH>
__device__ __forceinline__ int o_col(int tx, int n) {
  if constexpr (DH >= 32)
    return (n / 4) * 32 + tx * 4 + (n % 4);
  else
    return tx * 2 + n;
}

// One key tile: S for the live key groups, online softmax, P to shared
// memory, O += P V. FULL: all 64 keys are < T. BIAS: bt holds the tile's
// key bias in log2 units.
template <int DH, bool FULL, bool BIAS>
__device__ __forceinline__ void f32_tile(const float* Qs, const float* kt,
                                         const float* vt, const float* bt,
                                         float* Ps, int n_valid, int ty,
                                         int tx, float sl,
                                         float (&m)[F32Layout<DH>::RI],
                                         float (&l)[F32Layout<DH>::RI],
                                         float (&o)[F32Layout<DH>::RI]
                                                   [DH / 8]) {
  using L = F32Layout<DH>;
  constexpr int OC = DH / 8;
  constexpr int RI = L::RI;
  const int jmax = FULL ? 8 : (n_valid + 7) / 8;

  float s[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  // Not unrolled: each step already holds 128 independent FMAs, and
  // unrolling spills (ptxas, dh = 64).
#pragma unroll 1
  for (int d = 0; d < DH; d += 4) {
    float4 qv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * L::LDQ + d]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FULL || j < jmax) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&kt[(tx + 8 * j) * L::LDK + d]);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
  }

  // Scores in log2 units (scale * log2 e folded in), plus the key bias
  // (already in log2 units); keys >= T: -inf.
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float x;
      if constexpr (BIAS)
        x = fmaf(s[i][j], sl, bt[tx + 8 * j]);
      else
        x = s[i][j] * sl;
      s[i][j] = (FULL || tx + 8 * j < n_valid) ? x : -CUDART_INF_F;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // Every tile holds a key < T: the new max is finite.
    const float mn = fmaxf(m[i], mx);
    const float corr = exp2_approx(m[i] - mn);
    m[i] = mn;
    l[i] *= corr;
#pragma unroll
    for (int n = 0; n < OC; ++n) o[i][n] *= corr;
    float* prow = &Ps[(ty + 16 * i) * L::LDP];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FULL || j < jmax) {
        const float pv = exp2_approx(s[i][j] - mn);  // 2^-inf = 0
        l[i] += pv;
        prow[tx + 8 * j] = pv;
      }
    }
  }
  __syncwarp();  // a P row is written and read by the 8 threads of its warp

  const int n_c4 = FULL ? BK / 4 : (n_valid + 3) / 4;
#pragma unroll 2
  for (int c4 = 0; c4 < n_c4; ++c4) {
    float4 pv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      pv[i] = *reinterpret_cast<const float4*>(
          &Ps[(ty + 16 * i) * L::LDP + c4 * 4]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* vrow = &vt[(c4 * 4 + e) * L::LDV];
      float vv[OC];
      if constexpr (DH >= 32) {
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 x =
              *reinterpret_cast<const float4*>(&vrow[g * 32 + tx * 4]);
          vv[4 * g] = x.x;
          vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z;
          vv[4 * g + 3] = x.w;
        }
      } else {
        const float2 x = *reinterpret_cast<const float2*>(&vrow[tx * 2]);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                       : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int n = 0; n < OC; ++n) o[i][n] = fmaf(pe, vv[n], o[i][n]);
      }
    }
  }
  __syncwarp();  // P is overwritten by the next tile
}

template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS) attn_f32(const Params<float> p) {
  using L = F32Layout<DH>;
  constexpr int OC = DH / 8;
  constexpr int RI = L::RI;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qs = smem + L::Q;
  float* Ps = smem + L::P;
  float* Bs = smem + L::FLOATS;  // [STAGES][BK] if BIAS

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  int q0;
  const float *qg, *kg, *vg;
  float* og;
  const float* bg;
  head_ptrs<L::ROWS>(p, q0, qg, kg, vg, og, bg);
  const int seq = p.seq;

  load_rows<float, DH, L::ROWS>(Qs, L::LDQ, qg, p.sq.t, q0, seq, tid);
  load_rows<float, DH>(smem + L::K, L::LDK, kg, p.sk.t, 0, seq, tid);
  load_rows<float, DH>(smem + L::V, L::LDV, vg, p.sv.t, 0, seq, tid);
  cp_async_commit();
  if constexpr (BIAS) load_bias(Bs, bg, 0, seq, tid);

  float m[RI], l[RI], o[RI][OC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < OC; ++n) o[i][n] = 0.f;
  }
  const float sl = p.scale_log2;
  const int n_tiles = (seq + BK - 1) / BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = L::STAGES == 2 ? tile & 1 : 0;
    if constexpr (L::STAGES == 2) {
      if (tile + 1 < n_tiles) {
        load_rows<float, DH>(smem + L::K + (buf ^ 1) * BK * L::LDK, L::LDK,
                             kg, p.sk.t, (tile + 1) * BK, seq, tid);
        load_rows<float, DH>(smem + L::V + (buf ^ 1) * BK * L::LDV, L::LDV,
                             vg, p.sv.t, (tile + 1) * BK, seq, tid);
        cp_async_commit();
        if constexpr (BIAS)
          load_bias(Bs + (buf ^ 1) * BK, bg, (tile + 1) * BK, seq, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      // one buffer: refilled after the previous tile's closing barrier
      if (tile > 0) {
        load_rows<float, DH>(smem + L::K, L::LDK, kg, p.sk.t, tile * BK,
                             seq, tid);
        load_rows<float, DH>(smem + L::V, L::LDV, vg, p.sv.t, tile * BK,
                             seq, tid);
        cp_async_commit();
        if constexpr (BIAS) load_bias(Bs, bg, tile * BK, seq, tid);
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = smem + L::K + buf * BK * L::LDK;
    const float* vt = smem + L::V + buf * BK * L::LDV;
    const float* bt = Bs + buf * BK;
    const int n_valid = min(BK, seq - tile * BK);
    if (n_valid == BK)
      f32_tile<DH, true, BIAS>(Qs, kt, vt, bt, Ps, n_valid, ty, tx, sl, m, l,
                               o);
    else
      f32_tile<DH, false, BIAS>(Qs, kt, vt, bt, Ps, n_valid, ty, tx, sl, m,
                                l, o);
    __syncthreads();  // this buffer is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv = 1.f / l[i];
    float* orow = og + (long long)row * p.so.t;
    if constexpr (DH >= 32) {
#pragma unroll
      for (int g = 0; g < OC / 4; ++g)
        *reinterpret_cast<float4*>(&orow[o_col<DH>(tx, 4 * g)]) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
                        o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv);
    } else {
      *reinterpret_cast<float2*>(&orow[o_col<DH>(tx, 0)]) =
          make_float2(o[i][0] * inv, o[i][1] * inv);
    }
  }
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v, void* o,
                      int heads, int seq, const long long* st, float scale,
                      const float* bias, long long bias_stride) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  Strides* dst[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) *dst[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  p.bias = bias;
  p.sbias = bias_stride;
  p.heads = heads;
  p.seq = seq;
  p.n_qblocks = (seq + BQ - 1) / BQ;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return p;
}

// One block per (b, h, query block), the query blocks of one (b, h)
// adjacent; the dynamic shared-memory limit raised to the most the kernel
// ever takes (max_bytes).
template <auto Kernel, typename T>
int launch(const Params<T>& p, int batch, int bytes, int max_bytes,
           cudaStream_t s) {
  const int err = hop::raise_smem_limit<Kernel>(max_bytes);
  if (err) return err;
  const unsigned blocks =
      (unsigned)((long long)batch * p.heads * p.n_qblocks);
  Kernel<<<blocks, THREADS, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

// The variants (ops/attention.py's VARIANT_CODES). bf16: ops/attention.py's
// bf16_variant mirrors the rule (RULE): one key tile (T <= 64) the one-pass
// kernel; at dh = 64 up to 256 keys attn_bf16_wg (csrc/attention_wg.cu);
// more while the held scores fit (HeldLayout<DH, BIAS>::MAX_TILES) the held
// variant; beyond, the two-pass kernel. f32 (f32_variant): at dh = 64
// attn_f32_wg (csrc/attention_f32_wg.cu, TF32 wgmma on split operands, any
// T); at dh = 96, 128 and 192 up to SHORT_MAX_SEQ keys attn_f32_short
// (csrc/attention_short.cu, a warp a head); SIMT forces attn_f32<DH> on
// its 64-row tile at either; elsewhere only the rule (attn_f32<DH>).
// Another code forces that variant where it applies (the held variant at
// a wg shape, attn_f32<DH> beside attn_f32_wg or attn_f32_short, to time
// the two in one process) and is refused (cudaErrorInvalidValue) where it
// does not.
enum Variant {
  RULE = 0,
  ONE_PASS = 1,
  HELD = 2,
  TWO_PASS = 3,
  WG = 4,
  SIMT = 5,
  SHORT = 6
};

// The most keys attn_f32_short takes (a lane or more a query row).
constexpr int SHORT_MAX_SEQ = 32;

template <int DH>
int launch_f32(Params<float> p, int batch, int variant, const long long* st,
               cudaStream_t s) {
  using L = F32Layout<DH>;
  const bool short_seq =
      (DH == 96 || DH == 128 || DH == 192) && p.seq <= SHORT_MAX_SEQ;
  if (short_seq && (variant == RULE || variant == SHORT))
    return attention_f32_short_launch(p.q, p.k, p.v, p.o, batch, p.heads,
                                      p.seq, DH, st, p.scale, p.bias,
                                      p.sbias, s);
  if (DH == 64 && (variant == RULE || variant == WG))
    return attention_f32_wg_launch(p.q, p.k, p.v, p.o, batch, p.heads,
                                   p.seq, st, p.scale, p.bias, p.sbias, s);
  if (variant != RULE && !((DH == 64 || short_seq) && variant == SIMT))
    return (int)cudaErrorInvalidValue;
  p.n_qblocks = (p.seq + L::ROWS - 1) / L::ROWS;
  if (p.bias)
    return launch<attn_f32<DH, true>>(p, batch, L::BIAS_BYTES,
                                      L::BIAS_BYTES, s);
  return launch<attn_f32<DH, false>>(p, batch, L::BYTES, L::BYTES, s);
}

template <int DH, bool BIAS>
int launch_bf16_with(const Params<__nv_bfloat16>& p, int batch, int variant,
                     const long long* st, cudaStream_t s) {
  using L = Bf16Layout<DH>;
  using H = HeldLayout<DH, BIAS>;
  constexpr int bytes = BIAS ? L::BIAS_BYTES : L::BYTES;
  const int n_tiles = (p.seq + BK - 1) / BK;
  const bool wg = DH == 64 && p.seq >= WG_MIN_SEQ && p.seq <= WG_MAX_SEQ;
  if (variant == RULE)
    variant = n_tiles == 1           ? ONE_PASS
              : wg                   ? WG
              : n_tiles <= H::MAX_TILES ? HELD
                                        : TWO_PASS;
  switch (variant) {
    case ONE_PASS:
      if (n_tiles != 1) break;
      return launch<attn_bf16<DH, BIAS, false>>(p, batch, bytes, bytes, s);
    case WG:
      if (!wg) break;
      return attention_wg_launch(p.q, p.k, p.v, p.o, batch, p.heads, p.seq,
                                 st, p.scale, p.bias, p.sbias, s);
    case HELD:
      if (n_tiles == 1 || n_tiles > H::MAX_TILES) break;
      return launch<attn_bf16_held<DH, BIAS>>(p, batch, H::bytes(n_tiles),
                                              H::bytes(H::MAX_TILES), s);
    case TWO_PASS:
      if (n_tiles == 1) break;
      return launch<attn_bf16<DH, BIAS, true>>(p, batch, bytes, bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_bf16(const Params<__nv_bfloat16>& p, int batch, int variant,
                const long long* st, cudaStream_t s) {
  if (p.bias) return launch_bf16_with<DH, true>(p, batch, variant, st, s);
  return launch_bf16_with<DH, false>(p, batch, variant, st, s);
}

}  // namespace

// q, k, v: (batch, heads, seq, dh) views, f32 (is_bf16 = 0) or bf16, with
// element strides strides[0..2] (q), [3..5] (k), [6..8] (v) for batch,
// head and token; o is written through strides[9..11]. The last dim has
// stride 1; base pointers and strides are multiples of 16 bytes. dh in
// {16, 32, 64, 96, 128, 192}. bias: null, or a (batch, seq) f32 key bias whose
// rows are bias_stride elements apart (stride 1 along seq). variant: 0 (the
// rule), or a variant to force (Variant: bf16's; WG and SIMT for f32 at
// dh = 64, SHORT and SIMT at dh = 96, 128 and 192 up to 32 keys). Returns
// cudaGetLastError() after the launch.
extern "C" int vrt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int batch, int heads, int seq,
                                 int dh, const long long* strides,
                                 float scale, int is_bf16, const float* bias,
                                 long long bias_stride, int variant,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq <= 0 || batch <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const auto p = make_params<__nv_bfloat16>(q, k, v, o, heads, seq,
                                              strides, scale, bias,
                                              bias_stride);
    switch (dh) {
      case 16: return launch_bf16<16>(p, batch, variant, strides, s);
      case 32: return launch_bf16<32>(p, batch, variant, strides, s);
      case 64: return launch_bf16<64>(p, batch, variant, strides, s);
      case 96: return launch_bf16<96>(p, batch, variant, strides, s);
      case 128: return launch_bf16<128>(p, batch, variant, strides, s);
      case 192: return launch_bf16<192>(p, batch, variant, strides, s);
    }
  } else {
    const auto p = make_params<float>(q, k, v, o, heads, seq, strides, scale,
                                      bias, bias_stride);
    switch (dh) {
      case 16: return launch_f32<16>(p, batch, variant, strides, s);
      case 32: return launch_f32<32>(p, batch, variant, strides, s);
      case 64: return launch_f32<64>(p, batch, variant, strides, s);
      case 96: return launch_f32<96>(p, batch, variant, strides, s);
      case 128: return launch_f32<128>(p, batch, variant, strides, s);
      case 192: return launch_f32<192>(p, batch, variant, strides, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
