// The bf16 arithmetic that kernel B's bf16 kernels share
// (csrc/attention.cu: attn_bf16, attn_bf16_held; csrc/attention_wg.cu:
// attn_bf16_wg): the reference's bf16 score roundings, and P formed as the
// reference's softmax forms it, so that every variant gives the same P on
// the same scores.
//
// The bf16 kernels form P = bf16(exp(s - max) / sum) with the arithmetic of
// the reference's softmax (torch.softmax on the f32 scores, as
// attention_plain calls it; on the card softmax_warp_forward in ATen's
// PersistentSoftmax.cuh), so that where the scores agree P agrees to the
// bit:
// - the exp: expf (libdevice's, as std::exp there; the kernels build
//   without --use_fast_math, which would make it __expf) of the exact f32
//   difference s - max;
// - the sum: the row's exps against its final max, in that kernel's order
//   (RowSums);
// - the quotient: correctly rounded, as its division (quotient).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// e / l correctly rounded, from r = 1 / l correctly rounded (__frcp_rn, one
// a row): q = e r, then one FMA correction (Markstein). Exact while nothing
// underflows; with l in [1, T] that holds for e >= 2^-64
// (tests/test_torch_softmax_p.py holds it to IEEE division over 3 million
// pairs). p_frag takes IEEE division below.
__device__ __forceinline__ float quotient(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// The sum of a row's exps in the order of the reference's softmax
// (softmax_warp_forward): key j goes to lane j % 32 of one warp, each lane
// adds its keys from 0.0f in key order, and a butterfly adds the lanes over
// lane bits 4, 3, 2, 1, 0. In the mma accumulator layout (mma.sync m16n8,
// and wgmma's, which repeats it over the row's groups of 8 keys) a thread
// holds the keys 8 n + 2 c + e of rows g and g + 8 (c = lane % 4, key group
// n; attn_bf16's tiles of 64 keys number their groups 8 t + n): lane
// residue 8 (n % 4) + 2 c + e, taken in the order of n. So each thread keeps
// one sum a row for each (a = n % 4, e) (row_add), and the butterfly
// (row_total) adds a's bits 1 and 0 (lane bits 4, 3) in the thread, c's
// (bits 2, 1) across the row's four threads, and e (bit 0) in the thread.
// Each add rounds once (__fadd_rn: never contracted with the exp's last
// product into an FMA). Keys past T add exp(-inf) = 0 in both.
struct RowSums {
  float v[2][4][2];  // [row g, g + 8][a][e]
};
__device__ __forceinline__ void row_zero(RowSums& r) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) r.v[i][a][0] = r.v[i][a][1] = 0.f;
}
// key group n's exps: e0, e1 of row g (keys 2c, 2c + 1), e2, e3 of g + 8
__device__ __forceinline__ void row_add(RowSums& r, int n, float e0, float e1,
                                        float e2, float e3) {
  r.v[0][n & 3][0] = __fadd_rn(r.v[0][n & 3][0], e0);
  r.v[0][n & 3][1] = __fadd_rn(r.v[0][n & 3][1], e1);
  r.v[1][n & 3][0] = __fadd_rn(r.v[1][n & 3][0], e2);
  r.v[1][n & 3][1] = __fadd_rn(r.v[1][n & 3][1], e3);
}
__device__ __forceinline__ float row_total(const float (&v)[4][2]) {
  float x[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    x[e] = __fadd_rn(__fadd_rn(v[0][e], v[2][e]), __fadd_rn(v[1][e], v[3][e]));
    x[e] = __fadd_rn(x[e], __shfl_xor_sync(0xffffffffu, x[e], 2));
    x[e] = __fadd_rn(x[e], __shfl_xor_sync(0xffffffffu, x[e], 1));
  }
  return __fadd_rn(x[0], x[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_bf16(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The A fragment of P for one 16-key step from its eight exps (key groups
// 2kk and 2kk + 1: e[0..1], e[4..5] of row g, over l0 with r0 = 1 / l0;
// e[2..3], e[6..7] of row g + 8, over l1, r1): P = bf16(e / l), each
// quotient correctly rounded. The FMA route takes all eight. SAFE: an exp
// below its reach (0 < e < 2^-64: a score 44 below the row's max) is
// divided again by IEEE division, behind one branch for the eight. The
// kernels that know ahead whether a block (or warp) holds such an exp
// (tiny_exp) take SAFE only then: a branch in the hot loop, even one for
// eight values, measured slower on the H100 (PERF.md, Findings).
template <bool SAFE>
__device__ __forceinline__ void p_frag(uint32_t (&a)[4], const float (&e)[8],
                                       float l0, float r0, float l1,
                                       float r1) {
  float p[8], lo = e[0];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[i] = quotient(e[i], i & 2 ? l1 : l0, i & 2 ? r1 : r0);
    lo = fminf(lo, e[i]);
  }
  if (SAFE && lo < 0x1p-64f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (e[i] < 0x1p-64f) p[i] = __fdiv_rn(e[i], i & 2 ? l1 : l0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = pack_bf16(p[2 * j], p[2 * j + 1]);
}

// min(tiny, bits(e) - 1): below bits(2^-64) - 1 once some exp lies in (0,
// 2^-64), where the FMA quotient may round otherwise than IEEE division (an
// exp of 0, a key past T or a score 104 below the max, maps to the top).
__device__ __forceinline__ uint32_t tiny_exp(uint32_t tiny, float e) {
  return min(tiny, __float_as_uint(e) - 1u);
}
__device__ __forceinline__ bool has_tiny_exp(uint32_t tiny) {
  return tiny < __float_as_uint(0x1p-64f) - 1u;
}

// Two bf16 products and sums, each rounded once (.rn: never contracted
// into an FMA, which would round a * b + c once).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two adjacent keys' scores x0, x1 (f32 q k^T) rounded as the reference
// rounds its bf16 scores: bf16(bf16(bf16(q k^T) * bf16(scale)) +
// bf16(bias)); scale2 holds bf16(scale) twice, bias2 the keys' two bf16
// biases (BIAS).
template <bool BIAS>
__device__ __forceinline__ void round_scores(float& x0, float& x1,
                                             uint32_t scale2,
                                             uint32_t bias2) {
  uint32_t h = mul_bf16x2(pack_bf16(x0, x1), scale2);
  if constexpr (BIAS) h = add_bf16x2(h, bias2);
  x0 = lo_bf16(h);
  x1 = hi_bf16(h);
}

}  // namespace

// attn_bf16_wg (csrc/attention_wg.cu) at dh = 64, 64 < seq <= 256, with
// the arguments of vrt_attention_fwd; returns a cudaError_t.
int attention_wg_launch(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int seq,
                        const long long* strides, float scale,
                        const float* bias, long long bias_stride,
                        cudaStream_t stream);

// attn_bf16_wg's range (the rule of launch_bf16_with; ops/attention.py's
// bf16_variant mirrors it)
constexpr int WG_MIN_SEQ = 65, WG_MAX_SEQ = 256;
