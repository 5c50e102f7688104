// Multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces: vit_research_tpu/ops/attention.py::_attn_kernel (driven by
// _pallas_attention_fwd_impl, public entry multi_head_attention).
//
// Computes o = softmax(q k^T * scale) v per (batch*head), with f32 scores,
// f32 softmax and f32 accumulation; o is written in the input dtype
// (f32 or bf16). q, k, v, o are (BH, T, dh) contiguous.
//
// What bounds it on the H100: at ViT sequence lengths (T = 197..1297,
// dh = 64) attention is a small share of the encoder's FLOPs, and what a
// naive version pays is memory: the (T, T) score matrix per head would be
// written and read back from device memory. This version is bound by the
// f32 FMA rate of the CUDA cores (4*T*T*dh FLOPs per head), since it keeps
// the TPU kernel's f32 arithmetic and uses no tensor cores yet.
//
// What the design does about it: the TPU kernel kept all of K/V for one
// head in VMEM (T <= 4096). Shared memory is far smaller, so each block
// instead streams K/V through shared memory in tiles of 32 keys with an
// online softmax (running max and sum in f32), which removes any limit on
// T and keeps scores out of device memory. One thread owns one query row:
// its q row and its output accumulator live in registers, and every K/V
// element is read from shared memory as a broadcast float4, so each
// shared-memory load feeds four FMAs. mma.sync/wgmma are left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;   // queries (= threads) per block
constexpr int BKV = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(BQ)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq,
                 float scale) {
  __shared__ __align__(16) float Ks[BKV][DH];
  __shared__ __align__(16) float Vs[BKV][DH];

  const int tid = threadIdx.x;
  const long long head = blockIdx.x;
  const int row = blockIdx.y * BQ + tid;
  const bool row_ok = row < seq;
  const long long head_off = head * (long long)seq * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row_ok ? to_f32(q[head_off + (long long)row * DH + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;

  for (int j0 = 0; j0 < seq; j0 += BKV) {
    __syncthreads();  // the previous tile is no longer being read
#pragma unroll
    for (int i = 0; i < BKV * DH / BQ; ++i) {
      const int idx = tid + i * BQ;
      const int kj = idx / DH;
      const int d = idx - kj * DH;
      const int key = j0 + kj;
      const bool ok = key < seq;
      const long long off = head_off + (long long)key * DH + d;
      Ks[kj][d] = ok ? to_f32(k[off]) : 0.f;
      Vs[kj][d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int n_valid = min(BKV, seq - j0);
    float s[BKV];
    float m_tile = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&Ks[j][0]);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
      // Keys past the end of the sequence take no probability mass.
      s[j] = j < n_valid ? dot * scale : -CUDART_INF_F;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite and the
    // first tile's correction expf(-inf) is exactly 0.
    const float m_new = fmaxf(m_run, m_tile);
    const float corr = expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(&Vs[j][0]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      store(&o[head_off + (long long)row * DH + d], acc[d] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq, int dh, float scale, cudaStream_t stream) {
  dim3 grid((unsigned)bh, (unsigned)((seq + BQ - 1) / BQ));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (dh) {
    case 16:
      attention_kernel<T, 16><<<grid, BQ, 0, stream>>>(qp, kp, vp, op, seq, scale);
      break;
    case 32:
      attention_kernel<T, 32><<<grid, BQ, 0, stream>>>(qp, kp, vp, op, seq, scale);
      break;
    case 64:
      attention_kernel<T, 64><<<grid, BQ, 0, stream>>>(qp, kp, vp, op, seq, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, seq, dh) contiguous, f32 (is_bf16 = 0) or bf16;
// dh in {16, 32, 64}. Returns cudaGetLastError() after the launch.
extern "C" int vrt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int bh, int seq, int dh, float scale,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, bh, seq, dh, scale, s)
                 : launch<float>(q, k, v, o, bh, seq, dh, scale, s);
}
