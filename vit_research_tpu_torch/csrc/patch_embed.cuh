// What kernel A's two uint8 variants share (csrc/patch_embed.cu: the
// mma.sync variant on tc_gemm.cuh; csrc/patch_embed_wg.cu: the wgmma
// variant on wg_gemm.cuh): the image's geometry, the variant codes and the
// wgmma variant's entry point.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// An NHWC uint8 batch cut into P x P patches: row m = (b, gy, gx) of the
// patch-row matrix, column k = (py, px, c) fastest-last.
struct PatchGeometry {
  const uint8_t* img;
  int H, W, C, P, gw, n_patches, K;
  bool vec;  // 16-byte loads: P*C, W*C and the base are multiples of 16
};

inline PatchGeometry patch_geometry(const void* img, int H, int W, int C,
                                    int P) {
  PatchGeometry geo;
  geo.img = static_cast<const uint8_t*>(img);
  geo.H = H;
  geo.W = W;
  geo.C = C;
  geo.P = P;
  geo.gw = W / P;
  geo.n_patches = (H / P) * geo.gw;
  geo.K = P * P * C;
  geo.vec = (P * C) % 16 == 0 && (W * C) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(img) % 16 == 0;
  return geo;
}

// The codes of vrt_patch_embed_u8's variant argument: the rule takes the
// wgmma variant for every uint8 batch (mirrored in
// ops/patch_embed.py::patch_embed_variants).
enum PeVariant { PE_RULE = 0, PE_MMA = 1, PE_WG = 2 };

// patch_embed_wg (csrc/patch_embed_wg.cu) with vrt_patch_embed_u8's
// arguments; returns a cudaError_t.
int patch_embed_wg_launch(const void* img, const void* w3, int ldw,
                          const void* c, void* out, int B, int H, int W,
                          int C, int P, int D, int out_bf16,
                          cudaStream_t stream);
