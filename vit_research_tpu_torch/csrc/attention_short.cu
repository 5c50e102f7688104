// Kernel B's f32 variant for short sequences (attn_f32<DH>/short):
// softmax(q k^T * scale + key bias) v in f32 on the CUDA cores at dh = 96,
// 128 and 192 and T <= 32, with or without the key bias.
//
// Replaces: vit_research_tpu/ops/attention.py::_attn_kernel (driven by
// _pallas_attention_fwd_impl, public entry multi_head_attention) on f32 at
// those widths and lengths: the stage-1 chunk encoder (dh = 96, T = 9 to
// 25: stage 1, train-cached's encodes, the stage-2 cache build, eval-clips,
// live scoring) and the RAGHead (dh = 192, T = 5). csrc/attention.cu
// routes those calls here (launch_f32) and keeps attn_f32<DH> (its 64-row
// tile) to be forced beside it (variant "simt") and for T > 32.
//
// Computes what attn_f32<DH> computes: scores summed by fmaf over dh (in
// P parts, below), in log2 units (times scale * log2 e, plus the
// key bias times log2 e in one FMA), 2^(s - max) by ex2.approx (-inf past
// T), P V summed in f32 over the keys in order, O times 1 / (the row's
// sum).
//
// What bounds it on the H100: the bytes. A head at T = 9, dh = 96 does
// 2 * 2 * 9 * 9 * 96 = 31 kFLOP on 4 * 9 * 96 * 4 = 13.8 KB (2.3 FLOP a
// byte, against the f32 CUDA cores' 67 / 3.35 = 20), so the only gain is
// to keep enough bytes in flight to fill HBM: at B = 256, H = 8 the 28 MB
// take 0.0085 ms. attn_f32<DH> computes a 64-row query tile for T rows
// (86% of it idle at T = 9) and holds one block of 4 warps an SM, so each
// wave waits out a full load latency for a few KB.
//
// What the design does about it:
// - One warp a (b, h). Each query row belongs to P lanes (P = 4 at T <= 8,
//   2 at T <= 16, 1 up to 32), each taking every P-th float4 of dh, so
//   the lanes past T * P, idle, are fewer and each lane's work is 1 / P
//   of the row's; P - 1 shuffles a score add the parts. The row's scores,
//   max, sum and P then stay in its lanes' registers (the softmax takes no
//   shuffle), and every read of K and V from shared memory is a broadcast
//   or P neighbouring 16-byte groups, which meet no bank twice. Lanes past
//   T * P compute row T - 1 and store nothing.
// - Q, K and V arrive by 1-D bulk copies (cp.async.bulk, one a row: dh * 4
//   = 384, 512 or 768 bytes) on one mbarrier a warp, issued by T lanes at
//   once, through the caller's strides (the projections' (B, T, H, dh)
//   views need no copy). No tensor map: the host encodes nothing, so the
//   B = 1 call (stage 2's encodes) costs what attn_f32's launch costs.
//   Q rows are padded by 4 P floats, so the lanes' reads of their own rows
//   meet no bank twice in a quarter warp.
// - Shared memory holds one head a warp and nothing else (no P tile): 16
//   bytes of barrier, T rows of Q, NK rows of K, T rows of V, NK floats of
//   key bias; 11,824 bytes at T = 9, dh = 96. A block holds the 1-4 heads
//   (warps) that fit the most heads on an SM (heads_per_block), several
//   blocks share an SM, and nothing syncs across warps: each warp loads,
//   computes and stores its head on its own, so the SM keeps 16-18 heads'
//   copies in flight at T = 9 (one wave for B = 256, H = 8).
// - The score loop is unrolled over NK keys (T rounded up to 8, 12, 16 or
//   32: a template), so its NK sums are independent FMA chains; the keys
//   past T read K rows that are never loaded and are masked to -inf by a
//   select. P V takes the T live keys, up to 48 output columns a lane at a
//   time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_SEQ = 32;    // query rows: at least a lane each
constexpr int MAX_WARPS = 4;   // heads a block
constexpr int MAX_SMEM = 232448;  // what a block may opt into
// an SM's shared memory, and what the runtime keeps for each block
constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;
constexpr float LOG2E = 1.4426950408889634f;

// The keys the score loop computes for T keys (the template's NK).
constexpr int keys_for(int seq) {
  return seq <= 8 ? 8 : seq <= 12 ? 12 : seq <= 16 ? 16 : 32;
}
// Lanes a query row at NK keys: the rows' lanes share out its dh.
__host__ __device__ constexpr int lanes_a_row(int nk) {
  return nk <= 8 ? 4 : nk <= 16 ? 2 : 1;
}
// A head's shared memory (bytes): the barrier, T rows of Q (dh + 4 P
// floats), NK rows of K and T of V (dh floats), NK floats of key bias.
constexpr int head_bytes(int dh, int seq, bool bias) {
  return 16 + 4 * (seq * (dh + 4 * lanes_a_row(keys_for(seq))) +
                   keys_for(seq) * dh + seq * dh +
                   (bias ? keys_for(seq) : 0));
}
// Heads an SM holds with `warps` heads a block (0 if a block cannot).
constexpr int heads_per_sm(int bytes, int warps) {
  return warps * bytes > MAX_SMEM
             ? 0
             : SM_SMEM / (warps * bytes + BLOCK_RESERVED) * warps;
}
// Heads a block: the count up to MAX_WARPS that puts the most heads on an
// SM, the larger on a tie (fewer blocks).
constexpr int heads_per_block(int bytes) {
  int best = 1;
  for (int w = 2; w <= MAX_WARPS; ++w)
    if (heads_per_sm(bytes, w) >= heads_per_sm(bytes, best)) best = w;
  return best;
}
// The layout at the paths' shapes (ops/attention.py's tests pin the same).
static_assert(head_bytes(96, 9, false) == 11824 &&
                  heads_per_block(11824) == 3 &&
                  heads_per_sm(11824, 3) == 18,
              "dh = 96, T = 9: the chunk encoder");
static_assert(head_bytes(96, 25, false) == 31904 &&
                  heads_per_block(31904) == 1 &&
                  heads_per_sm(31904, 1) == 7,
              "dh = 96, T = 25: max_len 24 + CLS");
static_assert(head_bytes(192, 5, false) == 14160 &&
                  heads_per_block(14160) == 4 &&
                  heads_per_sm(14160, 4) == 16,
              "dh = 192, T = 5: the RAGHead");
static_assert(head_bytes(192, 32, true) == 74384 &&
                  heads_per_block(74384) == 3 &&
                  heads_per_sm(74384, 3) == 3,
              "the largest head fits");

struct ShortParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long sq_b, sq_h, sq_t, sk_b, sk_h, sk_t, sv_b, sv_h, sv_t, so_b,
      so_h, so_t;      // element strides (batch, head, token)
  const float* bias;   // (batch, seq) key bias or null
  long long sbias;     // its batch stride
  long long n_heads;   // batch * heads
  int heads, seq;
  int warps;           // heads a block
  int head_bytes;      // a warp's shared memory
  float scale_log2;    // scale * log2(e)
};

// 2^x in one SFU instruction (ex2.approx: relative error ~2^-22; 2^-inf =
// 0), as attn_f32 takes it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH, int NK, bool BIAS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 4)
    attn_f32_short(const ShortParams p) {
  constexpr int P = lanes_a_row(NK);
  constexpr int QLD = DH + 4 * P;  // Q's padded row pitch (floats)
  constexpr int G = DH / (4 * P);  // float4 groups of dh a lane
  // P V's float4 groups a pass: all of the lane's up to 48 columns, else 32
  constexpr int OG = G <= 12 ? G : 8;
  static_assert(G % 2 == 0 && G % OG == 0, "whole passes");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head = (long long)blockIdx.x * p.warps + warp;
  if (head >= p.n_heads) return;  // the whole warp: nothing syncs the block
  const int seq = p.seq;
  extern __shared__ float4 smem_f4[];
  char* region = reinterpret_cast<char*>(smem_f4) + warp * p.head_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(region);
  float* Qs = reinterpret_cast<float*>(region + 16);
  float* Ks = Qs + seq * QLD;
  float* Vs = Ks + NK * DH;
  float* Bs = Vs + seq * DH;  // NK floats, for BIAS

  const long long b = head / p.heads, h = head - b * p.heads;
  if (lane == 0) {
    hop::mbar_init(bar, 1);
    hop::fence_mbar_init();
    hop::mbar_expect_tx(bar, 3 * seq * DH * 4);
  }
  __syncwarp();
  if (lane < seq) {
    hop::bulk_load(Qs + lane * QLD, p.q + b * p.sq_b + h * p.sq_h +
                                        lane * p.sq_t, DH * 4, bar);
    hop::bulk_load(Ks + lane * DH, p.k + b * p.sk_b + h * p.sk_h +
                                       lane * p.sk_t, DH * 4, bar);
    hop::bulk_load(Vs + lane * DH, p.v + b * p.sv_b + h * p.sv_h +
                                       lane * p.sv_t, DH * 4, bar);
  }
  if constexpr (BIAS) {
    if (lane < NK)
      Bs[lane] = lane < seq ? p.bias[b * p.sbias + lane] * LOG2E : 0.f;
  }
  __syncwarp();  // the key bias, written by plain stores
  hop::mbar_wait(bar, 0);

  // Lane (r, part): query row r's float4 groups part, part + P, ... of dh.
  const int part = lane % P, r = lane / P;
  const int row = r < seq ? r : seq - 1;
  const float* qrow = Qs + row * QLD + 4 * part;
  const float* kcol = Ks + 4 * part;
  float s[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) s[j] = 0.f;
#pragma unroll 1
  for (int m = 0; m < G; m += 2) {
    float4 qv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qv[e] = *reinterpret_cast<const float4*>(qrow + 4 * P * (m + e));
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv = *reinterpret_cast<const float4*>(
            kcol + j * DH + 4 * P * (m + e));
        s[j] = fmaf(qv[e].x, kv.x, s[j]);
        s[j] = fmaf(qv[e].y, kv.y, s[j]);
        s[j] = fmaf(qv[e].z, kv.z, s[j]);
        s[j] = fmaf(qv[e].w, kv.w, s[j]);
      }
    }
  }
  // the row's P parts summed: every lane of the row holds its scores
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int off = 1; off < P; off <<= 1)
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);

  // Scores in log2 units, plus the key bias (already in log2 units); keys
  // >= T: -inf (key 0 is live, so the max is finite).
  const float sl = p.scale_log2;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    float x;
    if constexpr (BIAS)
      x = fmaf(s[j], sl, Bs[j]);
    else
      x = s[j] * sl;
    s[j] = j < seq ? x : -CUDART_INF_F;
    mx = fmaxf(mx, s[j]);
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    s[j] = exp2_approx(s[j] - mx);  // 2^-inf = 0
    l += s[j];
  }
  const float inv = 1.f / l;

  float* orow = p.o + b * p.so_b + h * p.so_h + (long long)row * p.so_t +
                4 * part;
  const float* vcol = Vs + 4 * part;
#pragma unroll 1
  for (int c = 0; c < G; c += OG) {
    float o[4 * OG];
#pragma unroll
    for (int n = 0; n < 4 * OG; ++n) o[n] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (j < seq) {  // the same in every lane
#pragma unroll
        for (int e = 0; e < OG; ++e) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vcol + j * DH + 4 * P * (c + e));
          o[4 * e] = fmaf(s[j], vv.x, o[4 * e]);
          o[4 * e + 1] = fmaf(s[j], vv.y, o[4 * e + 1]);
          o[4 * e + 2] = fmaf(s[j], vv.z, o[4 * e + 2]);
          o[4 * e + 3] = fmaf(s[j], vv.w, o[4 * e + 3]);
        }
      }
    }
    if (r < seq) {
#pragma unroll
      for (int e = 0; e < OG; ++e)
        *reinterpret_cast<float4*>(orow + 4 * P * (c + e)) =
            make_float4(o[4 * e] * inv, o[4 * e + 1] * inv,
                        o[4 * e + 2] * inv, o[4 * e + 3] * inv);
    }
  }
}

template <int DH, int NK, bool BIAS>
int launch(const ShortParams& p, unsigned blocks, cudaStream_t s) {
  const int err = hop::raise_smem_limit<attn_f32_short<DH, NK, BIAS>>(
      MAX_SMEM);
  if (err) return err;
  attn_f32_short<DH, NK, BIAS>
      <<<blocks, p.warps * 32, p.warps * p.head_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, bool BIAS>
int launch_keys(const ShortParams& p, unsigned blocks, cudaStream_t s) {
  switch (keys_for(p.seq)) {
    case 8: return launch<DH, 8, BIAS>(p, blocks, s);
    case 12: return launch<DH, 12, BIAS>(p, blocks, s);
    case 16: return launch<DH, 16, BIAS>(p, blocks, s);
    default: return launch<DH, 32, BIAS>(p, blocks, s);
  }
}

template <int DH>
int launch_width(const ShortParams& p, unsigned blocks, cudaStream_t s) {
  if (p.bias) return launch_keys<DH, true>(p, blocks, s);
  return launch_keys<DH, false>(p, blocks, s);
}

}  // namespace

// attn_f32_short at dh = 96, 128 or 192 and 1 <= seq <= 32, with the
// arguments of vrt_attention_fwd; returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
int attention_f32_short_launch(const void* q, const void* k, const void* v,
                               void* o, int batch, int heads, int seq, int dh,
                               const long long* strides, float scale,
                               const float* bias, long long bias_stride,
                               cudaStream_t stream) {
  if (seq <= 0 || seq > MAX_SEQ || batch <= 0 || heads <= 0 ||
      (dh != 96 && dh != 128 && dh != 192))
    return (int)cudaErrorInvalidValue;
  ShortParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  long long* dst[12] = {&p.sq_b, &p.sq_h, &p.sq_t, &p.sk_b, &p.sk_h, &p.sk_t,
                        &p.sv_b, &p.sv_h, &p.sv_t, &p.so_b, &p.so_h, &p.so_t};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  p.bias = bias;
  p.sbias = bias_stride;
  p.n_heads = (long long)batch * heads;
  p.heads = heads;
  p.seq = seq;
  p.head_bytes = head_bytes(dh, seq, bias != nullptr);
  p.warps = heads_per_block(p.head_bytes);
  p.scale_log2 = scale * LOG2E;
  const long long blocks = (p.n_heads + p.warps - 1) / p.warps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 96: return launch_width<96>(p, (unsigned)blocks, stream);
    case 128: return launch_width<128>(p, (unsigned)blocks, stream);
    default: return launch_width<192>(p, (unsigned)blocks, stream);
  }
}
