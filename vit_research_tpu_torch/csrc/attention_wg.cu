// Kernel B's bf16 variant for Hopper's own units: wgmma and TMA, at dh = 64
// and 64 < T <= 256 (the ViT-B/16 backbone at T = 197, ToMe's biased blocks
// from T = 197 down to 65).
//
// Replaces: vit_research_tpu/ops/attention.py::_attn_kernel (driven by
// _pallas_attention_fwd_impl, public entry multi_head_attention) on those
// shapes; csrc/attention.cu routes them here (launch_bf16_with) and keeps
// its other kernels for every other shape.
//
// Computes what attn_bf16_held computes, with the same roundings
// (attention_bf16.cuh): S = bf16(q k^T), then bf16(S * bf16(scale)), then
// bf16(S + bf16(bias)); P = bf16(expf(s - max) / sum) with the row's sum in
// the reference softmax's order (RowSums) and the correctly rounded
// quotient, IEEE division below 2^-64 (SAFE); O = P V, f32 accumulate,
// rounded to bf16.
//
// What bounds it on the H100 at B = 256, H = 12, T = 197: the bytes (q, k,
// v read once, o written once: 0.0925 ms) against 0.03 ms of tensor-core
// operations; around the tensor cores, each score's own work on the CUDA
// cores (three roundings, the max, one expf, its add into the row's sum and
// its quotient: some 20 instructions a score) with 8 warps an SM to hide
// its latency.
//
// What the design does about it. The TPU kernel holds a head's whole K/V and
// whole score row on chip; at T <= 256 Hopper can too:
// - Loads. One persistent block an SM walks over the (b, h) heads. Each
//   head's K and V are loaded once, with its Q tiles, by TMA (4-D tensor
//   maps over (dh, T, H, B) with the caller's strides, encoded on the host
//   each call; the token, head and batch dims in order of stride) into
//   128-byte-swizzled shared memory, in two stages: thread 0 loads the next
//   head while this one is computed, once every thread has released that
//   stage. Rows past T arrive as zeros (TMA's out-of-bounds fill). Each
//   stage has mbarriers: K with the Q tiles, V apart, and the release. A
//   key bias (ToMe's) is read by every thread a head ahead and published
//   on the same K barrier, so no head waits on a block-wide barrier.
// - S in registers. Two warpgroups, each on one 64-row Q tile at a time
//   (tiles wg, wg + 2 of the head; an odd count's last tile goes to each
//   in turn, head by head). wgmma forms S = Q K^T from shared
//   memory for the whole key row (m64n32k16 over NCH chunks of 32 keys, a
//   template argument: T rounded up to 32), so the row's scores stay in
//   f32 registers (16 NCH a thread) and no score goes to shared memory.
//   Every wgmma runs unconditionally: with the chain cut short at run time
//   (N = T rounded up to 8) ptxas serialized the wgmma and spilled.
// - Softmax in registers. Each thread rounds its scores, takes the rows'
//   max across the row's four threads and ONE expf a score, kept in
//   registers; keys past T are -inf (exp 0). wgmma's accumulator repeats
//   mma.sync m16n8's layout over the groups of 8 keys, so RowSums takes the
//   reference order unchanged (tests/test_torch_softmax_p.py models it).
// - P V. P is rounded to bf16 in registers as the A operand of a second
//   wgmma (m64n64k16, A from registers); V is its B operand from shared
//   memory, read transposed (MN-major) as TMA left it.
// - Padding rows: a warp whose 16 rows all lie past T skips the softmax (its
//   P is 0) and only takes part in the warpgroup's wgmma.
// - Output: O is staged through the tile's Q buffer (swizzled, so the
//   staging is free of bank conflicts) and written with 16-byte stores.
// The two warpgroups run independently: one's softmax overlaps the other's
// wgmma as the schedulers interleave them (no enforced ping-pong). A block
// is the two warpgroups, 256 threads of up to 255 registers (ptxas: 255 at
// NCH = 8, 242 at 7, 131-150 at 3; no spills), with up to 199,728 bytes of
// shared memory at T = 256: one block an SM. No producer warp: the loads
// need one thread a head, and a third warpgroup for them holds every
// thread to 168 registers at entry (65,536 / 384), which only setmaxnreg
// could shift to the consumers; without it every thread may hold 255.

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int ROW_BYTES = DH * 2;          // one 128-byte swizzle row
constexpr int QT_ROWS = 64;                // a wgmma's M
constexpr int QT_BYTES = QT_ROWS * ROW_BYTES;
constexpr int MAX_KEYS = WG_MAX_SEQ;
constexpr int CHUNK = 32;                  // keys a wgmma of S takes
constexpr int CONSUMERS = 2;               // warpgroups
constexpr int THREADS = CONSUMERS * 128;

struct WgParams {
  __nv_bfloat16* o;
  long long so_b, so_h, so_t;  // o's strides (elements)
  const float* bias;           // (batch, seq) key bias or null
  long long sbias;
  int heads, seq, n_items, n_qt;
  int krows;        // keys rounded up to 32: the K/V boxes' rows
  int stage_bytes;  // K, V, then the Q tiles
  float scale;
  // the TMA coordinate (1..3) of the token, head and batch of q, k, v
  int slot[3][3];
};

// A head's key bias (bf16) is written by every thread at the start of the
// head before it, and published on that head's k_full barrier. A thread at
// the start of head i has waited on head i - 1's k_full, which thread 0
// armed only after every thread released head i - 3: so head i + 1 may
// take the row of head i - 3, four rows in turn.
constexpr int BIAS_ROWS = 4;

// Shared memory: two stages, then BIAS_ROWS key-bias rows, then the
// barriers.
struct Smem {
  static constexpr int ALIGN = 1024;  // the 128-byte swizzle's atom
  __host__ __device__ static constexpr int bias_at(int stage_bytes) {
    return 2 * stage_bytes;
  }
  __host__ __device__ static constexpr int bars_at(int stage_bytes) {
    return bias_at(stage_bytes) + BIAS_ROWS * MAX_KEYS * 2;
  }
  __host__ __device__ static constexpr int bytes(int stage_bytes) {
    return ALIGN + bars_at(stage_bytes) + 6 * 8;
  }
};
constexpr int stage_bytes_of(int krows, int n_qt) {
  return 2 * krows * ROW_BYTES + n_qt * QT_BYTES;
}

// ------------------------------------------- barriers, TMA, wgmma's fences

using hop::mbar_arrive;
using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;
using hop::reg_fence;
using hop::sw128_desc;
using hop::wg_commit;
using hop::wg_fence;

// ------------------------------------------------------------------ wgmma

// d (+)= A B for 64 rows x 32 keys x 16 dh: A (Q) and B (K) K-major in
// shared memory; accumulate unless first.
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}
// o (+)= P V for 64 rows x 64 dh x 16 keys: P's A fragment in registers, V
// MN-major in shared memory (transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// ----------------------------------------------------------------- kernel

// P's A fragments of every 16-key step from the row's exps (p_frag; SAFE:
// with the IEEE fallback).
template <bool SAFE, int NCH>
__device__ __forceinline__ void p_frags(uint32_t (&a)[2 * NCH][4],
                                        const float (&s)[16 * NCH],
                                        float l0, float r0, float l1,
                                        float r1) {
#pragma unroll
  for (int kk = 0; kk < 2 * NCH; ++kk) {
    const float e[8] = {s[8 * kk],     s[8 * kk + 1], s[8 * kk + 2],
                        s[8 * kk + 3], s[8 * kk + 4], s[8 * kk + 5],
                        s[8 * kk + 6], s[8 * kk + 7]};
    p_frag<SAFE>(a[kk], e, l0, r0, l1, r1);
  }
}

// One Q tile of 64 rows (q0 on) against the head's K and V in shared
// memory, over NCH chunks of 32 keys (T <= 32 NCH; keys past T are zero
// rows of K and V). s[4 n + i]: key group n (keys 8 n + 2 c + i % 2, c =
// lane % 4) of row g = lane / 4 (i < 2) or g + 8 of the warp's 16, wgmma's
// layout. Every wgmma is unconditional: a chain that a branch cuts short
// keeps ptxas from pipelining it (and made it spill).
template <bool BIAS, int NCH>
__device__ __forceinline__ void wg_tile(const WgParams& p, char* qs,
                                        const char* ks, const char* vs,
                                        const __nv_bfloat16* bs,
                                        uint64_t* v_full, int v_parity,
                                        __nv_bfloat16* og, int q0, int wq,
                                        int lane) {
  constexpr int GROUPS = 4 * NCH, KSTEPS = 2 * NCH;
  const int seq = p.seq;
  float s[16 * NCH];  // each wgmma chain's first step overwrites

  // S = Q K^T, the whole key row
  const uint64_t dq = sw128_desc(qs), dk = sw128_desc(ks);
  reg_fence(s);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_n32(&s[16 * c], dq + 2 * kk,
                dk + (c * 32 * ROW_BYTES >> 4) + 2 * kk, kk);
  wg_commit();
  hop::wg_wait<0>();
  reg_fence(s);

  uint32_t a[KSTEPS][4];
  const bool active = q0 + 16 * wq < seq;  // a row of the warp lies below T
  if (active) {
    const int c2 = (lane & 3) * 2;
    const uint32_t scale2 = pack_bf16(p.scale, p.scale);  // bf16(scale) x 2
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < GROUPS; ++n) {
      float* x = &s[4 * n];
      const int col = 8 * n + c2;
      const uint32_t b2 =
          BIAS ? *reinterpret_cast<const uint32_t*>(&bs[col]) : 0u;
      round_scores<BIAS>(x[0], x[1], scale2, b2);
      round_scores<BIAS>(x[2], x[3], scale2, b2);
      if (n >= GROUPS - 4) {  // the last chunk: keys past T
        if (col >= seq) x[0] = x[2] = -CUDART_INF_F;
        if (col + 1 >= seq) x[1] = x[3] = -CUDART_INF_F;
      }
      m0 = fmaxf(m0, fmaxf(x[0], x[1]));
      m1 = fmaxf(m1, fmaxf(x[2], x[3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    // one exp a score, into the rows' sums in the reference's order; groups
    // wholly past T (in the last chunk) hold exps of 0 and add nothing
    RowSums sums;
    row_zero(sums);
    uint32_t tiny = ~0u;
#pragma unroll
    for (int n = 0; n < GROUPS; ++n) {
      float* x = &s[4 * n];
      if (n < GROUPS - 4 || 8 * n < seq) {
        x[0] = expf(x[0] - m0);
        x[1] = expf(x[1] - m0);
        x[2] = expf(x[2] - m1);
        x[3] = expf(x[3] - m1);
        row_add(sums, n, x[0], x[1], x[2], x[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) tiny = tiny_exp(tiny, x[i]);
      } else {
        x[0] = x[1] = x[2] = x[3] = 0.f;
      }
    }
    const float l0 = row_total(sums.v[0]), l1 = row_total(sums.v[1]);
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
    // SAFE where some exp of the warp's rows lies below 2^-64, the FMA
    // quotient's reach (a test on the scores, min(s) - max < -44, measured
    // 7% slower at T = 197)
    if (__any_sync(0xffffffffu, has_tiny_exp(tiny)))
      p_frags<true, NCH>(a, s, l0, r0, l1, r1);
    else
      p_frags<false, NCH>(a, s, l0, r0, l1, r1);
  } else {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
  }
  __syncwarp();

  // O = P V
  mbar_wait(v_full, v_parity);
  float o[32];  // the first step overwrites
  const uint64_t dv = sw128_desc(vs);
  reg_fence(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_pv(o, a[kk], dv + (kk * 16 * ROW_BYTES >> 4), kk);
  wg_commit();
  hop::wg_wait<0>();
  reg_fence(o);

  // O through the tile's Q buffer (free since S), in the 128-byte swizzle
  // (16-byte chunk ch of row r at chunk ch ^ (r % 8)), the warp's own 16 rows
  if (!active) return;
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wq + g + 8 * half;
      *reinterpret_cast<uint32_t*>(qs + r * ROW_BYTES +
                                   ((n ^ (r & 7)) << 4) + (lane & 3) * 4) =
          pack_bf16(o[4 * n + 2 * half], o[4 * n + 2 * half + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * wq + 4 * i + (lane >> 3), ch = lane & 7;
    if (q0 + r < seq)
      *reinterpret_cast<uint4*>(og + (long long)(q0 + r) * p.so_t + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + r * ROW_BYTES +
                                          ((ch ^ (r & 7)) << 4));
  }
}

template <bool BIAS, int NCH>
__global__ void __launch_bounds__(THREADS, 1)
attn_bf16_wg(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const WgParams p) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + Smem::ALIGN - 1) &
      ~(uintptr_t)(Smem::ALIGN - 1));
  auto stage = [&](int st) { return smem + st * p.stage_bytes; };
  const int k_at = 0, v_at = p.krows * ROW_BYTES, q_at = 2 * v_at;
  __nv_bfloat16* bias_s =
      reinterpret_cast<__nv_bfloat16*>(smem + Smem::bias_at(p.stage_bytes));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + Smem::bars_at(p.stage_bytes));
  uint64_t* k_full = bars;      // [2]: the Q tiles and K of a stage
  uint64_t* v_full = bars + 2;  // [2]: V
  uint64_t* empty = bars + 4;   // [2]: released by every consumer thread

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int st = 0; st < 2; ++st) {
      // TMA's transaction, and with a key bias every thread's row entry
      mbar_init(&k_full[st], 1 + (BIAS ? THREADS : 0));
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], CONSUMERS * 128);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  // Thread 0 loads head w into stage st: its Q tiles and K on k_full, V on
  // v_full (TMA; one thread's work, so no warp of its own).
  auto load_head = [&](int st, int w) {
    const int b = w / p.heads, h = w - (w / p.heads) * p.heads;
    char* base = stage(st);
    int c[4];
    auto coords = [&](int map, int token) {
      c[p.slot[map][0]] = token;
      c[p.slot[map][1]] = h;
      c[p.slot[map][2]] = b;
    };
    mbar_expect_tx(&k_full[st], p.n_qt * QT_BYTES + p.krows * ROW_BYTES);
    for (int qt = 0; qt < p.n_qt; ++qt) {
      coords(0, qt * QT_ROWS);
      hop::tma_load_4d(base + q_at + qt * QT_BYTES, &tq, &k_full[st], 0,
                       c[1], c[2], c[3]);
    }
    coords(1, 0);
    hop::tma_load_4d(base + k_at, &tk, &k_full[st], 0, c[1], c[2], c[3]);
    mbar_expect_tx(&v_full[st], p.krows * ROW_BYTES);
    coords(2, 0);
    hop::tma_load_4d(base + v_at, &tv, &v_full[st], 0, c[1], c[2], c[3]);
  };
  if (tid == 0) load_head(0, blockIdx.x);
  // With a key bias, thread tid holds key tid's bias of head w (0 past T),
  // loaded a head before it is written (rounded to bf16) to its row.
  auto bias_load = [&](int w) {
    return tid < p.seq ? p.bias[(long long)(w / p.heads) * p.sbias + tid]
                       : 0.f;
  };
  auto bias_store = [&](int it, float x) {
    if (tid < p.krows)
      bias_s[(it % BIAS_ROWS) * MAX_KEYS + tid] = __float2bfloat16_rn(x);
    mbar_arrive(&k_full[it & 1]);
  };
  const int stride = gridDim.x;
  float next_bias = 0.f;
  if constexpr (BIAS) {
    bias_store(0, bias_load(blockIdx.x));
    if (blockIdx.x + stride < p.n_items)
      next_bias = bias_load(blockIdx.x + stride);
  }

  const int wg = tid / 128, wq = warp & 3;  // warpgroup, its warp
  for (int it = 0, w = blockIdx.x; w < p.n_items; w += stride, ++it) {
    const int st = it & 1, parity = (it >> 1) & 1;
    // the next head into the other stage, once every thread released it
    // (head it - 1): its loads run under this head's work
    if (w + stride < p.n_items) {
      if (tid == 0) {
        if (it >= 1) mbar_wait(&empty[st ^ 1], ((it - 1) >> 1) & 1);
        load_head(st ^ 1, w + stride);
      }
      if constexpr (BIAS) {
        bias_store(it + 1, next_bias);
        if (w + 2 * stride < p.n_items) next_bias = bias_load(w + 2 * stride);
      }
    }
    const int b = w / p.heads, h = w - (w / p.heads) * p.heads;
    const __nv_bfloat16* bs = bias_s + (it % BIAS_ROWS) * MAX_KEYS;
    char* base = stage(st);
    __nv_bfloat16* og = p.o + b * p.so_b + h * p.so_h;
    mbar_wait(&k_full[st], parity);
    // tiles wg, wg + 2, ... of the head; with an odd count the warpgroups
    // take the odd tile in turns, head by head
    for (int qt = (wg + it * p.n_qt) & 1; qt < p.n_qt; qt += CONSUMERS) {
      char* qs = base + q_at + qt * QT_BYTES;
      wg_tile<BIAS, NCH>(p, qs, base + k_at, base + v_at, bs, &v_full[st],
                         parity, og, qt * QT_ROWS, wq, lane);
    }
    // the stage's generic reads and writes (O's staging) before the next
    // TMA writes into it
    hop::fence_proxy_async();
    mbar_arrive(&empty[st]);
  }
}

// ------------------------------------------------------------------- host

// A 4-D map of a (batch, heads, seq, 64) bf16 view (hop::head_map), boxes
// of `rows` tokens by the whole 128-byte row.
bool make_map(CUtensorMap* map, int (&slot)[3], const void* base, int batch,
              int heads, int seq, const long long* st, int rows) {
  return hop::head_map(map, slot, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                       DH, DH, batch, heads, seq, st, rows);
}

// Per device: the SM count (the persistent grid) and whether the kernels'
// shared-memory attribute is set.
struct DeviceState {
  int sms = 0;
  unsigned smem_set = 0;  // a bit for each instantiation: BIAS * 16 + NCH
};
DeviceState g_devices[64];

template <bool BIAS, int NCH>
int launch_wg(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const WgParams& p, DeviceState& ds,
              cudaStream_t s) {
  constexpr unsigned bit = 1u << (BIAS * 16 + NCH);
  if (!(ds.smem_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bf16_wg<BIAS, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem::bytes(stage_bytes_of(NCH * CHUNK, MAX_KEYS / QT_ROWS)));
    if (err != cudaSuccess) return (int)err;
    ds.smem_set |= bit;
  }
  const int grid = p.n_items < ds.sms ? p.n_items : ds.sms;
  attn_bf16_wg<BIAS, NCH><<<grid, THREADS, Smem::bytes(p.stage_bytes), s>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The instantiation of T's chunks of 32 keys (3 to 8).
template <bool BIAS>
int launch_chunks(const CUtensorMap (&maps)[3], const WgParams& p,
                  DeviceState& ds, cudaStream_t s) {
  switch (p.krows / CHUNK) {
    case 3: return launch_wg<BIAS, 3>(maps[0], maps[1], maps[2], p, ds, s);
    case 4: return launch_wg<BIAS, 4>(maps[0], maps[1], maps[2], p, ds, s);
    case 5: return launch_wg<BIAS, 5>(maps[0], maps[1], maps[2], p, ds, s);
    case 6: return launch_wg<BIAS, 6>(maps[0], maps[1], maps[2], p, ds, s);
    case 7: return launch_wg<BIAS, 7>(maps[0], maps[1], maps[2], p, ds, s);
    case 8: return launch_wg<BIAS, 8>(maps[0], maps[1], maps[2], p, ds, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

static_assert(Smem::bytes(stage_bytes_of(256, 4)) == 199728,
              "T = 256: one block an SM");

int attention_wg_launch(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int seq,
                        const long long* strides, float scale,
                        const float* bias, long long bias_stride,
                        cudaStream_t stream) {
  if (seq < WG_MIN_SEQ || seq > WG_MAX_SEQ) return (int)cudaErrorInvalidValue;
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
  WgParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.so_b = strides[9];
  p.so_h = strides[10];
  p.so_t = strides[11];
  p.bias = bias;
  p.sbias = bias_stride;
  p.heads = heads;
  p.seq = seq;
  p.n_items = batch * heads;
  p.n_qt = (seq + QT_ROWS - 1) / QT_ROWS;
  p.krows = (seq + CHUNK - 1) / CHUNK * CHUNK;
  p.stage_bytes = stage_bytes_of(p.krows, p.n_qt);
  p.scale = scale;
  alignas(64) CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_map(&maps[i], p.slot[i], bases[i], batch, heads, seq,
                  strides + 3 * i, i == 0 ? QT_ROWS : p.krows))
      return (int)cudaErrorInvalidValue;
  if (bias) return launch_chunks<true>(maps, p, ds, stream);
  return launch_chunks<false>(maps, p, ds, stream);
}
