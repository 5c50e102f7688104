// Kernel B's f32 variant for Hopper's tensor cores at dh = 64
// (attn_f32<64>/wg): softmax(q k^T * scale + key bias) v in f32, both
// products on TF32 wgmma with split operands (3xTF32), every T >= 1.
//
// Replaces: vit_research_tpu/ops/attention.py::_attn_kernel (driven by
// _pallas_attention_fwd_impl, public entry multi_head_attention) on f32 at
// dh = 64: the ViT-B/16 backbone (T = 197 at 224, 313 at smoke's 432x768),
// ToMe's biased blocks (T = 197 down to 21), and every other T.
// csrc/attention.cu routes those calls here (launch_f32) and keeps
// attn_f32<64> (CUDA cores) to be forced beside it (variant "simt").
//
// Computes what attn_f32<64> computes: scores in log2 units (q k^T times
// scale * log2 e, plus the key bias times log2 e in one FMA), an online
// softmax over stages of 64 keys (2^(s - max) by ex2.approx, -inf past T),
// f32 accumulation, O divided by the row's sum at the end. f32 accuracy on
// the tensor cores: every operand x is split into two TF32 pieces, hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each product is the
// three TF32 products lo hi + hi lo + hi hi summed into the f32
// accumulator (the lo lo term lies below f32's rounding). The result
// does not depend on torch.backends.cuda.matmul.allow_tf32: the kernel
// splits its operands itself. One TF32 pass (three digits) would not hold
// the f32 bound (tests/test_torch_tf32_split.py models both).
//
// What bounds it on the H100 at B = 256, H = 12, T = 197: the bytes (q, k,
// v read once, o written once: 0.185 ms) and, as deep, the three TF32
// passes (30.5 GFLOP each at 495 TFLOP/s: 0.185 ms together); the f32
// CUDA cores' peak (0.455 ms) is what attn_f32<64> is held to. Around
// the tensor cores: splitting every operand (K, V and P: four integer
// instructions and a subtraction a value), V's transpose, the online
// softmax, and the consumers' waits for them, which the tensor cores sit
// out (PERF.md has the times).
//
// What the design does about it:
// - TF32 wgmma takes both operands K-major only (the transpose bits are
//   f16/bf16's). S = Q K^T is K-major as it lies (dh innermost in Q and
//   K). P V is not: V lies (keys, dh). Of the two ways out, staging V^T
//   in shared memory (threads transpose what TMA brought) or forming
//   O^T = V^T P^T (V^T as a register A operand, P through shared memory
//   as B), the first is taken: V is transposed and split once a stage for
//   both consumer warpgroups, P stays in registers as the A operand of
//   P V (the S accumulator's layout, with V^T's columns ordered to
//   match: below), and O keeps the row layout the online softmax
//   rescales. The second would make every consumer load and split V into
//   registers itself, write its P (hi and lo) to shared memory, and hold
//   O transposed, each row's rescale factor spread over its threads.
// - A block is three warpgroups: a converter and two consumers, each
//   consumer on a 64-row Q tile of one (b, h) (an "item": two tiles; an
//   odd tile count's last item leaves the second consumer idle).
//   setmaxnreg gives the converter 96 registers a thread and each
//   consumer 200. One persistent block an SM walks its items; the stages
//   of all its items form one pipeline, so the next item's first stage
//   loads and splits under this item's last one.
// - The converter. Its thread 0 loads by TMA (4-D tensor maps over (dh,
//   T, H, B) with the caller's strides, so the projections' (B, T, H, dh)
//   views need no copy; rows past T arrive as zeros) each stage's 64 keys
//   of K and V into a raw ring of two slots, and each item's Q tiles.
//   Its 128 threads split every stage while the consumers compute the one
//   before: K into K hi (in place: 128-byte swizzle, two atoms a 64-float
//   row) and K lo, and V into V^T hi and lo (dh rows of the stage's keys,
//   in the swizzle wgmma reads) in a split ring of two slots. Each thread
//   moves a 4-key x 4-dh block of V (float4 reads and writes), lanes
//   rotating which of their four rows they write first, so that neither
//   the reads nor the writes of a quarter-warp meet in a bank. It also
//   writes the stage's key terms (the bias in log2 units, -inf past T).
//   Each slot's completion and release are mbarriers: TMA's transaction,
//   the split, the consumers' S (K hi read), their P V (the split slot
//   read), their Q reads.
// - The consumers, a stage: S = Q K^T by 24 wgmma m64n64k8 (lo hi from
//   the Q lo tile each consumer writes at the item's start, hi lo and hi
//   hi with Q hi from registers); softmax in registers (each row's max
//   across its four threads, one ex2 a score, P split in registers); a
//   warp whose 16 rows all lie past T skips it (its P is 0). Then P V by
//   24 wgmma with P from registers, summed from 0 for the stage and added
//   to O in f32 (O = O 2^(m_old - m_new) + P V): the tensor cores' adds
//   truncate, and accumulated over every stage of a long row O drifts
//   (as C's split products do: Plan::FLUSH in csrc/tc_gemm.cuh).
//   wgmma's accumulator gives thread (g, c) keys 8n + 2c and 8n + 2c + 1
//   of key group n; the tf32 A fragment wants k-indices c and c + 4 of a
//   k-step. k-step kk = 2m + pi takes the keys of parity pi of groups 2m
//   and 2m + 1 (16m + pi + 2j for k-index j), so V^T's column 8 kk + j
//   holds key 16m + pi + 2j, and P needs no shuffle.
// - Output: O divided by the row's sum, written from registers as float2
//   (a quarter-warp fills whole 32-byte sectors).
// 384 threads, 230,992 bytes of shared memory: one block an SM.

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int ROWS = 64;          // a Q tile (a wgmma's M); a key stage
constexpr int ATOM = ROWS * 128;  // 64 rows of one swizzle atom (32 floats)
constexpr int TILE = 2 * ATOM;    // 64 rows x 64 floats: 16,384 bytes
constexpr int CONSUMERS = 2;      // warpgroups, a Q tile each
constexpr int THREADS = (1 + CONSUMERS) * 128;  // and the converter's
// setmaxnreg: the converter's and each consumer's registers, within the
// 168 a thread the launch gives (65,536 / 384, rounded down to 8)
constexpr int CONVERTER_REGS = 96, CONSUMER_REGS = 200;
static_assert(128 * CONVERTER_REGS + CONSUMERS * 128 * CONSUMER_REGS <=
                  THREADS * 168,
              "the block's registers");
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1,024-byte-aligned base.
struct Smem {
  // raw ring: two slots of K (split to K hi in place) and V as TMA writes
  // them
  static constexpr int RAW_SLOT = 2 * TILE, RAW_V = TILE;
  // split ring: two slots of K lo, V^T hi, V^T lo
  static constexpr int SPLIT = 2 * RAW_SLOT, SPLIT_SLOT = 3 * TILE;
  static constexpr int K_LO = 0, VT_HI = TILE, VT_LO = 2 * TILE;
  // the item's Q tiles as TMA writes them, then their TF32 lo pieces
  static constexpr int Q = SPLIT + 2 * SPLIT_SLOT;
  static constexpr int Q_LO = Q + CONSUMERS * TILE;
  // a stage's key terms: bias * log2 e, 0 without a bias, -inf past T
  static constexpr int KEYS = Q_LO + CONSUMERS * TILE;
  static constexpr int BARS = KEYS + 2 * ROWS * 4;
  static constexpr int N_BARS = 10;
  static constexpr int ALIGN = 1024;
  static constexpr int BYTES = ALIGN + BARS + N_BARS * 8;
};
static_assert(Smem::BYTES == 230992, "one block an SM");
static_assert(Smem::BYTES <= 232448, "what a block may opt into");

struct F32WgParams {
  float* o;
  long long so_b, so_h, so_t;  // o's strides (elements)
  const float* bias;           // (batch, seq) key bias or null
  long long sbias;
  int heads, seq;
  int n_qt;     // Q tiles (= key stages) of a head: ceil(seq / 64)
  int n_pairs;  // items of a head: ceil(n_qt / 2)
  int n_items;  // batch * heads * n_pairs
  float scale_log2;
  // the TMA coordinate (1..3) of the token, head and batch of q, k, v
  int slot[3][3];
};

using hop::fence_proxy_async;
using hop::mbar_arrive;
using hop::mbar_expect_tx;
using hop::mbar_wait;
using hop::reg_fence;
using hop::tf32_desc;
using hop::tf32_rna;
using hop::wg_commit;
using hop::wg_fence;
using hop::wgmma_tf32_rs;

// 2^x in one SFU instruction (attn_f32's exp; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, the two TF32 pieces of a 3xTF32 product
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}
__device__ __forceinline__ void split4(const float4& x, float4& hi,
                                       float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}
// v's components rotated left by r (0..3): component j of the result is
// v's component (j + r) % 4, by selects.
__device__ __forceinline__ float4 rotl(float4 v, int r) {
  if (r & 1) v = make_float4(v.y, v.z, v.w, v.x);
  if (r & 2) v = make_float4(v.z, v.w, v.x, v.y);
  return v;
}
template <int J>
__device__ __forceinline__ float comp(const float4& v) {
  return J == 0 ? v.x : J == 1 ? v.y : J == 2 ? v.z : v.w;
}

// V -> V^T, one 4-key x 4-dh block of the stage: item i (< 256) takes dh
// quad q4 (dh 4 q4 .. 4 q4 + 3) of keys 16m + pi + 8hh + 2e (e < 4), which
// are V^T's columns 16m + 8pi + 4hh + e. A quarter-warp shares m, pi, hh
// and takes q4 % 8 = 0..7: its reads hit 8 chunks (q4 % 8 ^ key % 8), and
// in write step s lane q4 writes dh row 4 q4 + (s + rot) % 4, rot = q4 / 2
// % 4, so the rows' % 8 differ too: no bank is met twice.
__device__ __forceinline__ void transpose_v(const char* raw_v, char* dst,
                                            int i) {
  const int q4 = i & 15, rest = i >> 4;
  const int m = rest >> 2, pi = (rest >> 1) & 1, hh = rest & 1;
  const int rot = (q4 >> 1) & 3;
  float4 x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * m + pi + 8 * hh + 2 * e;
    x[e] = rotl(*reinterpret_cast<const float4*>(
                    raw_v + (q4 >> 3) * ATOM + r * 128 +
                    (((q4 & 7) ^ (r & 7)) << 4)),
                rot);
  }
  const int chunk = 4 * (m & 1) + 2 * pi + hh;  // in the 128-byte row
  char* vh = dst + Smem::VT_HI + (m >> 1) * ATOM;
  char* vl = dst + Smem::VT_LO + (m >> 1) * ATOM;
  auto put = [&](int s, const float4& y) {
    const int d = 4 * q4 + ((s + rot) & 3);
    const int off = d * 128 + ((chunk ^ (d & 7)) << 4);
    float4 hi, lo;
    split4(y, hi, lo);
    *reinterpret_cast<float4*>(vh + off) = hi;
    *reinterpret_cast<float4*>(vl + off) = lo;
  };
  put(0, make_float4(comp<0>(x[0]), comp<0>(x[1]), comp<0>(x[2]),
                     comp<0>(x[3])));
  put(1, make_float4(comp<1>(x[0]), comp<1>(x[1]), comp<1>(x[2]),
                     comp<1>(x[3])));
  put(2, make_float4(comp<2>(x[0]), comp<2>(x[1]), comp<2>(x[2]),
                     comp<2>(x[3])));
  put(3, make_float4(comp<3>(x[0]), comp<3>(x[1]), comp<3>(x[2]),
                     comp<3>(x[3])));
}

// The converter's share of one stage (t: its thread, < 128): K of a raw
// slot into K hi (in place) and K lo (split slot), V into V^T hi and lo
// (split slot), and the stage's key terms (key0: the stage's first key,
// bias: the item's row or null).
__device__ __forceinline__ void convert(char* raw, char* dst, float* keys,
                                        const float* bias, int key0, int seq,
                                        int t) {
#pragma unroll 4
  for (int i = 0; i < 8; ++i) {  // K: 1,024 float4
    const int off = (t + i * 128) * 16;
    float4 hi, lo;
    split4(*reinterpret_cast<const float4*>(raw + off), hi, lo);
    *reinterpret_cast<float4*>(raw + off) = hi;
    *reinterpret_cast<float4*>(dst + Smem::K_LO + off) = lo;
  }
  transpose_v(raw + Smem::RAW_V, dst, t);
  transpose_v(raw + Smem::RAW_V, dst, t + 128);
  if (t < ROWS) {
    const int key = key0 + t;
    keys[t] = key >= seq ? -CUDART_INF_F : bias ? bias[key] * LOG2E : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attn_f32_wg(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const F32WgParams p) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + Smem::ALIGN - 1) &
      ~(uintptr_t)(Smem::ALIGN - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::BARS);
  uint64_t* full = bars;        // [2]: a raw slot's TMA
  uint64_t* conv = bars + 2;    // [2]: a stage split, by the converter
  uint64_t* s_done = bars + 4;  // [2]: a raw slot's K hi read (consumers)
  uint64_t* pv = bars + 6;      // [2]: a split slot read (consumers)
  uint64_t* q_full = bars + 8;
  uint64_t* q_free = bars + 9;  // the consumers have read the item's Q
  float* keys = reinterpret_cast<float*>(smem + Smem::KEYS);
  constexpr int CONS = CONSUMERS * 128;

  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&conv[i], 128);
      hop::mbar_init(&s_done[i], CONS);
      hop::mbar_init(&pv[i], CONS);
    }
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_free, CONS);
    hop::fence_mbar_init();
  }
  __syncthreads();

  // This block's items blockIdx.x + k gridDim.x (k < n_mine), each n_st
  // stages: flat stage f = k n_st + s, in raw and split slot f % 2.
  const int n_st = p.n_qt, stride = gridDim.x;
  const int n_mine = (p.n_items - (int)blockIdx.x + stride - 1) / stride;
  const int n_flat = n_mine * n_st;
  auto item = [&](int k) { return (int)blockIdx.x + k * stride; };
  auto head_of = [&](int w, int& b, int& h) {
    const int bh = w / p.n_pairs;
    b = bh / p.heads;
    h = bh - b * p.heads;
  };
  auto raw_slot = [&](int f) { return smem + (f & 1) * Smem::RAW_SLOT; };
  auto split_slot = [&](int f) {
    return smem + Smem::SPLIT + (f & 1) * Smem::SPLIT_SLOT;
  };

  if (wg == 0) {
    // ------------------------------------------------ the converter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        CONVERTER_REGS));
    // thread 0: a box of `map` (64 tokens from `token` of item w's head)
    // in its two 128-byte atoms
    auto tma = [&](const CUtensorMap* map, int which, char* dst,
                   uint64_t* bar, int w, int token) {
      int b, h, cd[4];
      head_of(w, b, h);
      cd[p.slot[which][0]] = token;
      cd[p.slot[which][1]] = h;
      cd[p.slot[which][2]] = b;
      hop::tma_load_4d(dst, map, bar, 0, cd[1], cd[2], cd[3]);
      hop::tma_load_4d(dst + ATOM, map, bar, 32, cd[1], cd[2], cd[3]);
    };
    auto load_stage = [&](int f) {  // into raw slot f % 2
      const int k = f / n_st, s = f - k * n_st, w = item(k);
      mbar_expect_tx(&full[f & 1], 2 * TILE);
      tma(&tk, 1, raw_slot(f), &full[f & 1], w, s * ROWS);
      tma(&tv, 2, raw_slot(f) + Smem::RAW_V, &full[f & 1], w, s * ROWS);
    };
    auto load_q = [&](int k) {  // item k's Q tiles that hold rows below T
      const int w = item(k), t0 = CONSUMERS * (w % p.n_pairs);
      const int live = min(CONSUMERS, p.n_qt - t0);
      mbar_expect_tx(q_full, live * TILE);
      for (int t = 0; t < live; ++t)
        tma(&tq, 0, smem + Smem::Q + t * TILE, q_full, w, (t0 + t) * ROWS);
    };
    for (int f = 0; f < n_flat; ++f) {
      const int k = f / n_st, s = f - k * n_st;
      if (tid == 0) {
        if (f == 0) {
          load_q(0);
          load_stage(0);
          if (n_flat > 1) load_stage(1);
        } else {
          if (s == 0) {  // the Q buffer, once item k - 1's Q is read
            mbar_wait(q_free, (k - 1) & 1);
            load_q(k);
          }
          if (f >= 2) {  // raw slot f % 2, once stage f - 2's K hi is read
            mbar_wait(&s_done[f & 1], ((f - 2) >> 1) & 1);
            load_stage(f);
          }
        }
      }
      // split slot f % 2, once stage f - 2's P V has read it
      if (f >= 2) mbar_wait(&pv[f & 1], ((f - 2) >> 1) & 1);
      mbar_wait(&full[f & 1], (f >> 1) & 1);
      int b, h;
      head_of(item(k), b, h);
      convert(raw_slot(f), split_slot(f), keys + (f & 1) * ROWS,
              p.bias ? p.bias + b * p.sbias : nullptr, s * ROWS, p.seq, tid);
      fence_proxy_async();  // for wgmma's reads, and the raw slot's TMA
      mbar_arrive(&conv[f & 1]);
    }
    return;
  }

  // -------------------------------------------------------- the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int ct = tid - 128, cw = wg - 1, wq = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const float sl = p.scale_log2;
  uint32_t qh[8][4];  // the warp's Q fragments, TF32 hi (lo: Q_LO)
  float o[32], m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int f = 0; f < n_flat; ++f) {
    const int k = f / n_st, s = f - k * n_st, w = item(k);
    const int tile = CONSUMERS * (w % p.n_pairs) + cw;
    const bool live = tile < p.n_qt;  // the warpgroup's tile has rows < T
    const int q0 = tile * ROWS;
    char* ql = smem + Smem::Q_LO + cw * TILE;
    if (s == 0) {  // the item's Q: hi fragments in registers, lo tile
      mbar_wait(q_full, k & 1);
      if (live) {
        const char* qs = smem + Smem::Q + cw * TILE;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int off = ((ct & 127) + 128 * i) * 16;
          float4 hi, lo;
          split4(*reinterpret_cast<const float4*>(qs + off), hi, lo);
          *reinterpret_cast<float4*>(ql + off) = lo;
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * wq + g + 8 * (i & 1);
            const int ch = 2 * (kk & 3) + (i >> 1);
            const float x = *reinterpret_cast<const float*>(
                qs + (kk >> 2) * ATOM + r * 128 + ((ch ^ (r & 7)) << 4) +
                c * 4);
            qh[kk][i] = __float_as_uint(tf32_rna(x));
          }
        fence_proxy_async();  // Q lo for wgmma; the Q buffer's next TMA
        hop::named_sync(1 + cw, 128);
      } else {
        fence_proxy_async();
      }
      mbar_arrive(q_free);
    }
    mbar_wait(&conv[f & 1], (f >> 1) & 1);
    if (!live) {
      mbar_arrive(&s_done[f & 1]);
      mbar_arrive(&pv[f & 1]);
      continue;
    }
    const char* rk = raw_slot(f);
    const char* sp = split_slot(f);

    // S = Q K^T: lo hi + hi lo + hi hi
    float sc[32];  // the first wgmma overwrites
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hop::wgmma_tf32_ss(sc, tf32_desc(ql, ROWS, kk), tf32_desc(rk, ROWS, kk),
                         kk);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(sc, qh[kk], tf32_desc(sp + Smem::K_LO, ROWS, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(sc, qh[kk], tf32_desc(rk, ROWS, kk), 1);
    wg_commit();
    hop::wg_wait<0>();
    reg_fence(sc);
    mbar_arrive(&s_done[f & 1]);

    // softmax: sc[4n + i] is key 8n + 2c + i % 2 of row g (i < 2) or g + 8
    float pl[32], r0 = 1.f, r1 = 1.f;
    if (q0 + 16 * wq < p.seq) {
      const float* kt = keys + (f & 1) * ROWS;
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 kb = *reinterpret_cast<const float2*>(kt + 8 * n + 2 * c);
        sc[4 * n] = fmaf(sc[4 * n], sl, kb.x);
        sc[4 * n + 1] = fmaf(sc[4 * n + 1], sl, kb.y);
        sc[4 * n + 2] = fmaf(sc[4 * n + 2], sl, kb.x);
        sc[4 * n + 3] = fmaf(sc[4 * n + 3], sl, kb.y);
        x0 = fmaxf(x0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      // every stage holds a key < T: the new maxima are finite
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      r0 = exp2_approx(m0 - n0);
      r1 = exp2_approx(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= r0;
      l1 *= r1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float e = exp2_approx(sc[i] - ((i & 2) ? m1 : m0));
        if (i & 2)
          l1 += e;
        else
          l0 += e;
        split(e, sc[i], pl[i]);
      }
    } else {  // every row of the warp lies past T
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = pl[i] = 0.f;
    }

    // the stage's P V from 0 (lo hi + hi lo + hi hi), then O = O r + P V in
    // f32: the tensor cores' own sums run over this stage only. k-step kk
    // = 2m + pi takes keys 16m + pi + 2j (j < 8): sc[8m + pi + {0, 2, 4, 6}]
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * (kk >> 1) + (kk & 1) + 2 * j;
        ah[kk][j] = __float_as_uint(sc[i]);
        al[kk][j] = __float_as_uint(pl[i]);
      }
    float ot[32];  // the first wgmma overwrites
    reg_fence(ot);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(ot, al[kk], tf32_desc(sp + Smem::VT_HI, ROWS, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(ot, ah[kk], tf32_desc(sp + Smem::VT_LO, ROWS, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(ot, ah[kk], tf32_desc(sp + Smem::VT_HI, ROWS, kk), 1);
    wg_commit();
    hop::wg_wait<0>();
    reg_fence(ot);
    mbar_arrive(&pv[f & 1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] = fmaf(o[4 * n], r0, ot[4 * n]);
      o[4 * n + 1] = fmaf(o[4 * n + 1], r0, ot[4 * n + 1]);
      o[4 * n + 2] = fmaf(o[4 * n + 2], r1, ot[4 * n + 2]);
      o[4 * n + 3] = fmaf(o[4 * n + 3], r1, ot[4 * n + 3]);
    }

    if (s == n_st - 1) {  // the item's last stage: O / l, then reset
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      int b, h;
      head_of(w, b, h);
      float* og = p.o + b * p.so_b + h * p.so_h;
      const int row0 = q0 + 16 * wq + g, row1 = row0 + 8;
      const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (row0 < p.seq)
          *reinterpret_cast<float2*>(og + row0 * p.so_t + 8 * n + 2 * c) =
              make_float2(o[4 * n] * i0, o[4 * n + 1] * i0);
        if (row1 < p.seq)
          *reinterpret_cast<float2*>(og + row1 * p.so_t + 8 * n + 2 * c) =
              make_float2(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m0 = m1 = -CUDART_INF_F;
      l0 = l1 = 0.f;
    }
  }
}

// Per device: the SM count (the persistent grid) and whether the kernel's
// shared-memory attribute is set.
struct DeviceState {
  int sms = 0;
  bool smem_set = false;
};
DeviceState g_devices[64];

}  // namespace

// attn_f32_wg at dh = 64 and any seq >= 1, with the arguments of
// vrt_attention_fwd; returns a cudaError_t.
int attention_f32_wg_launch(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int seq,
                            const long long* strides, float scale,
                            const float* bias, long long bias_stride,
                            cudaStream_t stream) {
  if (seq <= 0 || batch <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  DeviceState& ds = g_devices[dev];
  if (ds.sms == 0) {
    err = cudaDeviceGetAttribute(&ds.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (!ds.smem_set) {
    err = cudaFuncSetAttribute(attn_f32_wg,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem::BYTES);
    if (err != cudaSuccess) return (int)err;
    ds.smem_set = true;
  }
  F32WgParams p;
  p.o = static_cast<float*>(o);
  p.so_b = strides[9];
  p.so_h = strides[10];
  p.so_t = strides[11];
  p.bias = bias;
  p.sbias = bias_stride;
  p.heads = heads;
  p.seq = seq;
  p.n_qt = (seq + ROWS - 1) / ROWS;
  p.n_pairs = (p.n_qt + CONSUMERS - 1) / CONSUMERS;
  const long long items = (long long)batch * heads * p.n_pairs;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.n_items = (int)items;
  p.scale_log2 = scale * LOG2E;
  alignas(64) CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!hop::head_map(&maps[i], p.slot[i], bases[i],
                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, DH, 32, batch,
                       heads, seq, strides + 3 * i, ROWS))
      return (int)cudaErrorInvalidValue;
  const int grid = p.n_items < ds.sms ? p.n_items : ds.sms;
  attn_f32_wg<<<grid, THREADS, Smem::BYTES, stream>>>(maps[0], maps[1],
                                                      maps[2], p);
  return (int)cudaGetLastError();
}
