// The encoder's f32 linears on Hopper's tensor cores (gemm_f32_wg):
// out = x W^T + bias with x (M, K), W (N, K) and out (M, N) f32 row-major
// (W as nn.Linear stores it), on TF32 wgmma with split operands (3xTF32).
//
// Replaces no TPU kernel: the JAX package leaves these products (the
// nn.Dense q, k, v, out, fc1 and fc2 of vit_research_tpu/models/vit.py)
// to XLA. Added because on cuBLAS's f32 GEMM, which runs on the CUDA
// cores (~67 TFLOP/s), they were 86-88% of the f32 forward's device time
// (PERF.md §5). ops/linear.py routes models/vit.py::_dense here by its
// rule (inference on a CUDA tensor, f32, K % BK == 0, N % BN == 0, enough
// rows) and keeps cuBLAS for the rest.
//
// Arithmetic: f32 accuracy on the tensor cores, whatever
// torch.backends.cuda.matmul.allow_tf32 says. Every operand v is split
// into two TF32 pieces, hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v -
// hi) (hop::tf32_rna), and each product is lo hi + hi lo + hi hi (the lo
// lo term lies below f32's rounding). The tensor cores' accumulator adds
// truncate, so a chain of 3 K / 8 wgmma adds drifts (~2e-5 relative at
// K = 3072, Plan::FLUSH in csrc/tc_gemm.cuh): each stage's 12 products
// (BK = 32 deep) are summed from 0 and added to the f32 accumulator with
// a rounded add. The bias is added in f32 in the epilogue.
//
// What bounds it on the H100 at the backbone's M = 50,432 (B = 256, T =
// 197): the three TF32 passes at 495 TFLOP/s, 0.361 ms at (K, N) = (768,
// 768) and 1.443 ms at (768, 3072) and (3072, 768), against 0.093 and
// 0.234 ms of bytes (x, W, bias read once, out written once). Around the
// tensor cores: each stage's wgmma read W's two pieces from shared memory
// (1/16 byte a TF32 multiply-add: half the SM's 128 bytes a cycle at the
// full rate), the split of every operand, and each stage's wait for its
// products before the rounded add.
//
// What the design does about it:
// - x comes as it lies, by TMA (a 2-D map over the caller's row stride,
//   the 128-byte swizzle, rows past M as zeros) into a ring of STAGES
//   stages, and is split in registers by the consumers: wgmma takes A from
//   registers, so x's pieces never go back to shared memory.
// - W must be read by wgmma from shared memory, so its pieces are made
//   there: a converter warpgroup loads each stage's BN x BK block of W
//   from global memory (L2; a stage ahead, in registers), splits it and
//   stores hi and lo in the swizzle wgmma reads. No copy of W exists
//   outside the kernel, so a changed weight is read as it is on the next
//   call: nothing is cached.
// - Two consumer warpgroups, each 64 rows x BN columns of a BM x BN tile,
//   12 wgmma m64n128k8 a stage (lo hi, hi lo, hi hi with A from
//   registers) into a stage accumulator, then added to the tile's
//   accumulator: 64 + 64 f32 registers, the reason BN stays at 128.
//   setmaxnreg gives each consumer 200 registers and the converter 104.
// - One persistent block an SM walks its tiles (column tiles fastest, so
//   the blocks in flight share their rows of x and all of W in L2); the
//   stages of all its tiles form one ring, so the next tile's first
//   stages load and split during this tile's epilogue.
// - The epilogue writes float2 from registers (a quarter-warp fills whole
//   32-byte sectors) with the bias read through L1 (the converter's
//   loads of W bypass L1, so the bias stays there).
// 384 threads, 197,696 bytes of shared memory: one block an SM.

#include <cuda.h>  // CUtensorMap's types; the encoder is found at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // columns a tile: a wgmma's N
constexpr int BK = 32;   // k a stage: one 128-byte swizzle row of f32
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (1 + CONSUMERS) * 128;  // and the converter's
constexpr int ACC = BN / 2;  // f32 accumulators a consumer thread
// setmaxnreg: the converter's and each consumer's registers, within the
// 168 a thread the launch gives (65,536 / 384, rounded down to 8)
constexpr int CONVERTER_REGS = 104, CONSUMER_REGS = 200;
static_assert(128 * CONVERTER_REGS + CONSUMERS * 128 * CONSUMER_REGS <=
                  THREADS * 168,
              "the block's registers");
constexpr int W_LOADS = BN * BK / 4 / 128;  // float4 a converter thread

// Shared memory, from a 1,024-byte-aligned base: the ring, then the
// barriers.
struct Smem {
  static constexpr int X = BM * 128;  // x's tile as TMA writes it
  static constexpr int W = BN * 128;  // one piece of W's tile
  static constexpr int W_HI = X, W_LO = X + W;
  static constexpr int STAGE = X + 2 * W;
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int N_BARS = 2 * STAGES;
  static constexpr int ALIGN = 1024;
  static constexpr int BYTES = ALIGN + BARS + N_BARS * 8;
};
static_assert(Smem::BYTES == 197696, "one block an SM");
static_assert(Smem::BYTES <= 232448, "what a block may opt into");
static_assert(Smem::STAGE % 1024 == 0, "every tile on the swizzle's phase");

struct LinearArgs {
  const float* w;     // (N, K) row-major
  const float* bias;  // (N,) or null
  float* out;         // (M, N) row-major
  long long M;
  int K, N;
  int kt;       // stages a tile: K / BK
  int n_nt;     // column tiles: N / BN
  int n_tiles;  // ceil(M / BM) * n_nt
};

using hop::fence_proxy_async;
using hop::mbar_arrive;
using hop::mbar_wait;
using hop::reg_fence;
using hop::tf32_rna;

// TF32 wgmma, m64n128k8, f32 accumulate: d (+)= A B with A from registers
// (the m16n8k8 tf32 A fragment of the warp's 16 rows: (g, c), (g + 8, c),
// (g, c + 4), (g + 8, c + 4) for g = lane / 4, c = lane % 4) and B K-major
// from shared memory (its descriptor); accumulating unless `accumulate`
// is 0.
__device__ __forceinline__ void wgmma_n128(float (&d)[ACC],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The K-major descriptor of k-step kk (8 floats, 32 bytes; kk < 4) of a
// tile of 128-byte rows in the 128-byte swizzle.
__device__ __forceinline__ uint64_t kstep_desc(const char* tile, int kk) {
  return hop::sw128_desc(tile + kk * 32);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_wg(const __grid_constant__ CUtensorMap tx, const LinearArgs p) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + Smem::ALIGN - 1) &
      ~(uintptr_t)(Smem::ALIGN - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::BARS);
  // ready[s]: x's TMA (thread 0's arrival with its bytes) and W's split
  // (the converter's 128 arrivals); empty[s]: the stage read (every
  // consumer warp)
  uint64_t* ready = bars;
  uint64_t* empty = bars + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&ready[s], 128 + 1);
      hop::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hop::fence_mbar_init();
  }
  __syncthreads();

  // This block's tiles blockIdx.x + t gridDim.x (t < n_mine), column tiles
  // fastest; flat stage f = t kt + ks in ring slot f % STAGES.
  const int first = blockIdx.x, stride = gridDim.x;
  const int n_mine =
      first < p.n_tiles ? (p.n_tiles - first + stride - 1) / stride : 0;
  const int n_flat = n_mine * p.kt;
  auto slot = [&](int f) { return smem + (f % STAGES) * Smem::STAGE; };

  if (wg == 0) {
    // ------------------------------------------------ the converter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        CONVERTER_REGS));
    // Thread t's share of a stage: float4 i is row (t + 128 i) / 8 of W's
    // block, 16-byte chunk (t + 128 i) % 8 of its 128 bytes of k; eight
    // lanes read one row's 128 bytes and write its 8 chunks, each to
    // chunk ^ (row % 8): no bank is met twice.
    auto load_w = [&](float4 (&r)[W_LOADS], int f) {
      const int t = f / p.kt, ks = f - t * p.kt;
      const int n0 = ((first + t * stride) % p.n_nt) * BN;
      const float* src = p.w + (long long)n0 * p.K + ks * BK;
#pragma unroll
      for (int i = 0; i < W_LOADS; ++i) {
        const int e = tid + 128 * i, row = e >> 3, ch = e & 7;
        r[i] = __ldcg(reinterpret_cast<const float4*>(
            src + (long long)row * p.K + 4 * ch));
      }
    };
    float4 cur[W_LOADS], nxt[W_LOADS];
    if (n_flat > 0) load_w(cur, 0);
    for (int f = 0; f < n_flat; ++f) {
      if (f + 1 < n_flat) load_w(nxt, f + 1);
      const int s = f % STAGES;
      // the slot, once stage f - STAGES has been read
      if (f >= STAGES) mbar_wait(&empty[s], ((f / STAGES) - 1) & 1);
      char* st = slot(f);
      if (tid == 0) {
        const int t = f / p.kt, ks = f - t * p.kt;
        const int m0 = ((first + t * stride) / p.n_nt) * BM;
        hop::mbar_expect_tx(&ready[s], Smem::X);
        hop::tma_load_2d(st, &tx, &ready[s], ks * BK, m0);
      }
#pragma unroll
      for (int i = 0; i < W_LOADS; ++i) {
        const int e = tid + 128 * i, row = e >> 3, ch = e & 7;
        const int off = row * 128 + ((ch ^ (row & 7)) << 4);
        const float4 v = cur[i];
        float4 hi, lo;
        hi.x = tf32_rna(v.x);
        hi.y = tf32_rna(v.y);
        hi.z = tf32_rna(v.z);
        hi.w = tf32_rna(v.w);
        lo.x = tf32_rna(v.x - hi.x);
        lo.y = tf32_rna(v.y - hi.y);
        lo.z = tf32_rna(v.z - hi.z);
        lo.w = tf32_rna(v.w - hi.w);
        *reinterpret_cast<float4*>(st + Smem::W_HI + off) = hi;
        *reinterpret_cast<float4*>(st + Smem::W_LO + off) = lo;
      }
      fence_proxy_async();  // the pieces, for wgmma's reads
      mbar_arrive(&ready[s]);
#pragma unroll
      for (int i = 0; i < W_LOADS; ++i) cur[i] = nxt[i];
    }
    return;
  }

  // -------------------------------------------------------- the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int cw = wg - 1, wq = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int t = 0, f = 0; t < n_mine; ++t) {
    for (int ks = 0; ks < p.kt; ++ks, ++f) {
      const int s = f % STAGES;
      mbar_wait(&ready[s], (f / STAGES) & 1);
      const char* st = slot(f);
      // x's fragments of the warp's 16 rows, split: row 16 wq + g (+ 8),
      // k-step kk's floats c and c + 4 (chunks 2 kk and 2 kk + 1; the row's
      // % 8 is g)
      const char* xs = st + (cw * 64 + 16 * wq + g) * 128 + c * 4;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = 2 * kk + (i >> 1);
          const float v = *reinterpret_cast<const float*>(
              xs + (i & 1) * 8 * 128 + ((ch ^ g) << 4));
          const float hi = tf32_rna(v);
          ah[kk][i] = __float_as_uint(hi);
          al[kk][i] = __float_as_uint(tf32_rna(v - hi));
        }
      // the stage's products from 0: lo hi, hi lo, hi hi
      float part[ACC];  // the first wgmma overwrites
      reg_fence(part);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n128(part, al[kk], kstep_desc(st + Smem::W_HI, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n128(part, ah[kk], kstep_desc(st + Smem::W_LO, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n128(part, ah[kk], kstep_desc(st + Smem::W_HI, kk), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      reg_fence(part);
      // the stage read (x's generic reads ordered before the next TMA)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // a rounded f32 add: the tensor cores' own sums run over a stage
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }

    // the epilogue: out = acc + bias, rows 16 wq + g (acc 4n, 4n + 1) and
    // + 8 (4n + 2, 4n + 3), columns 8n + 2c, + 1
    const int tile = first + t * stride, mt = tile / p.n_nt;
    const long long row0 = (long long)mt * BM + cw * 64 + 16 * wq + g;
    const long long row1 = row0 + 8;
    const int col0 = (tile - mt * p.n_nt) * BN + 2 * c;
#pragma unroll
    for (int n = 0; n < ACC / 4; ++n) {
      const int col = col0 + 8 * n;
      const float b0 = p.bias ? __ldg(p.bias + col) : 0.f;
      const float b1 = p.bias ? __ldg(p.bias + col + 1) : 0.f;
      if (row0 < p.M)
        *reinterpret_cast<float2*>(p.out + row0 * p.N + col) =
            make_float2(acc[4 * n] + b0, acc[4 * n + 1] + b1);
      if (row1 < p.M)
        *reinterpret_cast<float2*>(p.out + row1 * p.N + col) =
            make_float2(acc[4 * n + 2] + b0, acc[4 * n + 3] + b1);
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  }
}

// Per device: the SM count (the persistent grid).
int g_sms[64];

}  // namespace

// out (M, N) = x W^T + bias on gemm_f32_wg: x (M, K) with row stride lda
// (elements), W (N, K) and out (M, N) contiguous f32, bias (N,) f32 or
// null. K % BK == 0 and N % BN == 0; x and W 16-byte aligned, lda a
// multiple of 4 (TMA's row stride and the float4 loads); out 8-byte
// aligned. Returns a cudaError_t (cudaErrorInvalidValue for what it does
// not take, before any launch).
extern "C" int vrt_linear_f32(const void* x, const void* w, const void* bias,
                              void* out, long long M, int K, int N,
                              long long lda, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % BK != 0 || N % BN != 0 ||
      lda < K || lda % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (M + BM - 1) / BM * (N / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int code = hop::raise_smem_limit<gemm_f32_wg>(Smem::BYTES);
  if (code != 0) return code;

  const hop::EncodeTiled encode = hop::encoder();
  if (!encode) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)lda * 4};
  const cuuint32_t box[2] = {BK, BM}, step[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  LinearArgs p;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.kt = K / BK;
  p.n_nt = N / BN;
  p.n_tiles = (int)tiles;
  const int grid = p.n_tiles < g_sms[dev] ? p.n_tiles : g_sms[dev];
  gemm_f32_wg<<<grid, THREADS, Smem::BYTES,
                static_cast<cudaStream_t>(stream)>>>(map, p);
  return (int)cudaGetLastError();
}
