"""Fused normalise + patchify + project: CUDA kernels and plain version.

Port of vit_research_tpu/ops/patch_embed.py. The embedding engine ships
uint8 NHWC frames to the device; this op turns them into (B, N, D) patch
tokens in one pass,

    uint8/float image -> (x * a - b)   per-channel affine (rescale+normalise)
                      -> patch rows    (B*N, P*P*C), (py, px, c) fastest-last
                      -> rows @ W + c  patch projection

with the affine folded into two K-length vectors by :func:`fold_affine`.
On a CUDA tensor :func:`fused_patch_embed` launches a hand-written kernel
whose tile loader does the patchify, so the normalised f32 image never
exists in device memory. For uint8 images (the engine's) the wrapper first
folds the affine into the projection and splits it into three bf16 pieces
(:func:`fold_split_weight`), so the kernel multiplies on the bf16 tensor
cores with f32 accuracy; two variants take them (:func:`patch_embed_variants`):

- ``"wg"``, the rule's (``csrc/patch_embed_wg.cu``, on the wgmma mainloop
  of ``csrc/wg_gemm.cuh``: the pieces by TMA, wgmma from shared memory);
- ``"mma"`` (``csrc/patch_embed.cu``, on the mma.sync mainloop of
  ``csrc/tc_gemm.cuh``), for measurement beside it
  (``fused_patch_embed(..., variant="mma")``).

float32 images take ``csrc/patch_embed.cu``'s f32 CUDA-core kernel, which
applies the affine in its loader (no variant to force). On a CPU tensor it
runs :func:`patch_embed_plain`.

Gradients with respect to ``w`` and ``bias`` come from :class:`_PatchEmbed`,
a ``torch.autograd.Function`` whose backward is the VJP of
:func:`patch_embed_plain`, as the reference's ``custom_vjp`` takes the VJP
of ``_rows_project_xla``. It saves the images and the unfolded weight, not
the kernel's folded and split pieces: the backward recomputes what it
needs (the normalised rows) from the images. The images take no grad.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

_OUT_DTYPES = (torch.float32, torch.bfloat16)
#: the code of each uint8 variant at the C entry point
#: (csrc/patch_embed.cuh's PeVariant); 0 is the rule
VARIANT_CODES = {"mma": 1, "wg": 2}


def patch_embed_variants(dtype: torch.dtype) -> tuple:
    """Every variant that takes images of ``dtype``, the rule's first:
    ``("wg", "mma")`` for uint8; none to force for float32 (its one
    kernel)."""
    return ("wg", "mma") if dtype == torch.uint8 else ()


def kernel_name(dtype: torch.dtype, variant: str | None = None) -> str:
    """The name a launch counts under in
    ``fused_patch_embed.launches_by_kernel``: ``patch_embed_u8/wg`` (the
    rule's) or ``patch_embed_u8/mma`` for uint8, ``patch_embed_f32``."""
    if dtype != torch.uint8:
        return "patch_embed_f32"
    return f"patch_embed_u8/{variant or patch_embed_variants(dtype)[0]}"


def _check_variant(variant, dtype: torch.dtype) -> None:
    """Raise ValueError unless ``variant`` is None or takes the images."""
    takes = patch_embed_variants(dtype)
    if variant is not None and variant not in takes:
        raise ValueError(f"variant {variant!r} does not take "
                         f"{str(dtype).split('.')[-1]} images (they take "
                         f"{', '.join(takes) or 'no variant to force'})")


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C) patch rows, (py, px, c) fastest-last
    (an HWIO conv kernel reshaped to (P*P*C, D) uses the same order).
    Trailing rows/columns that do not fill a patch are cropped (VALID)."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images[:, : gh * p, : gw * p, :]
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def fold_affine(patch_size: int, channels: int = 3, *, rescale: float = 1.0,
                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """Fold rescale+normalise into K-length float32 (a, b) numpy vectors:
    ``a[k] = rescale / std[c(k)]``, ``b[k] = mean[c(k)] / std[c(k)]``."""
    k = patch_size * patch_size * channels
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    a = np.tile(rescale / std, k // channels).astype(np.float32)
    b = np.tile(mean / std, k // channels).astype(np.float32)
    return a, b


@functools.lru_cache(maxsize=32)
def _affine_on(device: torch.device, patch_size: int, channels: int,
               rescale: float, mean: tuple, std: tuple):
    a, b = fold_affine(patch_size, channels, rescale=rescale, mean=mean,
                       std=std)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def patch_embed_plain(images, w, bias, a_vec, b_vec, *, patch_size: int,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: patchify, affine and matmul in f32.
    Returns (B*N, D)."""
    rows = patchify(images, patch_size)
    rows = rows.reshape(-1, rows.shape[-1]).to(torch.float32)
    x = rows * a_vec - b_vec
    return (x @ w + bias).to(out_dtype)


def fold_split_weight(w, bias, a_vec, b_vec):
    """Fold the affine into the projection and split it for the bf16
    tensor cores.

    ``(rows * a - b) @ W + bias == rows @ W' + c`` with ``W' = a[:, None] *
    W`` and ``c = bias - b @ W``. Returns ``(pieces, c)``: ``pieces`` (3, K,
    D') bfloat16 with ``hi + mid + lo == W'`` to f32 precision (24
    significand bits; columns D..D'-1, D' = D rounded up to a multiple of
    8 for 16-byte rows, are zero) and ``c`` (D,) float32. A uint8 pixel times a piece is exact in
    f32, so ``sum_p rows @ pieces[p] + c`` in f32 is the f32 projection."""
    k, d = w.shape
    folded = a_vec[:, None] * w
    d_pad = -(-d // 8) * 8
    if d_pad != d:
        folded = torch.nn.functional.pad(folded, (0, d_pad - d))
    pieces = torch.empty((3, k, d_pad), dtype=torch.bfloat16,
                         device=w.device)
    rest = folded
    for i in range(3):
        pieces[i].copy_(rest)
        if i < 2:
            rest = rest - pieces[i]  # exact in f32
    c = bias - (b_vec[:, None] * w).sum(0)
    return pieces, c


def _check(images, w, bias, a_vec, b_vec, patch_size, out_dtype):
    if images.dim() != 4:
        raise ValueError(f"images must be (B, H, W, C), got "
                         f"{tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got "
                        f"{images.dtype}")
    b, h, wd, c = images.shape
    k = patch_size * patch_size * c
    if h < patch_size or wd < patch_size:
        raise ValueError(f"image {h}x{wd} is smaller than one "
                         f"{patch_size}x{patch_size} patch")
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w must be (P*P*C = {k}, D), got {tuple(w.shape)}")
    d = w.shape[1]
    for name, t, shape in (("bias", bias, (d,)), ("a_vec", a_vec, (k,)),
                           ("b_vec", b_vec, (k,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def _launch(images, w, bias, a_vec, b_vec, patch_size, out_dtype,
            variant=None):
    from vit_research_tpu_torch.ops import _build

    dev = images.device
    for name, t in (("w", w), ("bias", bias), ("a_vec", a_vec),
                    ("b_vec", b_vec)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, images on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    _check_variant(variant, images.dtype)
    if images.dtype == torch.uint8:
        pieces, bias_c = fold_split_weight(w, bias, a_vec, b_vec)
        return launch_u8(images, pieces, bias_c, patch_size, out_dtype,
                         variant)
    b, h, wd, c = images.shape
    p = patch_size
    d = w.shape[1]
    out = torch.empty(((h // p) * (wd // p) * b, d), dtype=out_dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vrt_patch_embed_f32(
            images.data_ptr(), w.data_ptr(), a_vec.data_ptr(),
            b_vec.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd, c,
            p, d, int(out_dtype == torch.bfloat16), stream)
    _build.check(code, "patch_embed kernel")
    _count(images.dtype)
    return out


def launch_u8(images, pieces, bias_c, patch_size: int, out_dtype,
              variant: str | None = None) -> torch.Tensor:
    """The uint8 kernel alone on :func:`fold_split_weight`'s ``pieces``
    (3, K, D') bf16 and folded bias ``bias_c`` (D,) f32, on the card:
    (B*N, D) in ``out_dtype``. ``variant``: None (the rule's, ``"wg"``) or
    ``"mma"``. :func:`fused_patch_embed` calls it after folding; a
    measurement times it to separate the kernel from the fold."""
    from vit_research_tpu_torch.ops import _build

    if images.dtype != torch.uint8:
        raise TypeError(f"launch_u8 takes uint8 images, got {images.dtype}")
    _check_variant(variant, images.dtype)
    dev = images.device
    b, h, wd, c = images.shape
    p = patch_size
    d = bias_c.shape[0]
    if pieces.shape[-1] % 8 or pieces.data_ptr() % 16 or \
            not pieces.is_contiguous():
        raise ValueError("pieces must be contiguous and 16-byte aligned "
                         "with rows of a multiple of 8 values")
    out = torch.empty(((h // p) * (wd // p) * b, d), dtype=out_dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vrt_patch_embed_u8(
            images.data_ptr(), pieces.data_ptr(), pieces.shape[-1],
            bias_c.data_ptr(), out.data_ptr(), b, h, wd, c, p, d,
            int(out_dtype == torch.bfloat16),
            VARIANT_CODES[variant] if variant else 0, stream)
    _build.check(code, "patch_embed kernel")
    _count(images.dtype, variant)
    return out


def _count(dtype: torch.dtype, variant: str | None = None) -> None:
    # plain increments: exact because device work is serialized (the
    # serve daemon runs every forward under its one device lock)
    fused_patch_embed.launches += 1
    fused_patch_embed.launches_by_kernel[kernel_name(dtype, variant)] += 1


def _forced(variant) -> tuple:
    """The trailing argument of :func:`_forward` for a forced variant; none
    for the rule's, so that its seven-argument form (which tests stand in
    for) stays the common call."""
    return () if variant is None else (variant,)


def _forward(images, w, bias, a_vec, b_vec, patch_size, out_dtype,
             variant=None):
    """The kernel on a CUDA tensor, the plain version on a CPU one:
    (B*N, D)."""
    if images.device.type == "cpu":
        return patch_embed_plain(images, w, bias, a_vec, b_vec,
                                 patch_size=patch_size, out_dtype=out_dtype)
    if images.device.type == "cuda":
        return _launch(images, w, bias, a_vec, b_vec, patch_size, out_dtype,
                       variant)
    raise ValueError(f"unsupported device {images.device}")


class _PatchEmbed(torch.autograd.Function):
    """Forward: :func:`_forward` (the kernel on CUDA). Backward: the VJP
    of :func:`patch_embed_plain` with respect to ``w`` and ``bias``."""

    @staticmethod
    def forward(ctx, images, w, bias, a_vec, b_vec, patch_size, out_dtype,
                variant):
        ctx.save_for_backward(w, bias)
        # The images and the affine vectors take no grad and may be
        # inference tensors (the engine runs under inference_mode, and
        # _affine_on caches its vectors), which save_for_backward refuses.
        ctx.images, ctx.affine = images, (a_vec, b_vec)
        ctx.cfg = dict(patch_size=patch_size, out_dtype=out_dtype)
        return _forward(images, w, bias, a_vec, b_vec, patch_size,
                        out_dtype, *_forced(variant))

    @staticmethod
    def backward(ctx, grad):
        w, bias = ctx.saved_tensors
        params = [t.detach().requires_grad_(need)
                  for t, need in zip((w, bias), ctx.needs_input_grad[1:3])]
        wanted = [t for t in params if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = patch_embed_plain(ctx.images, *params, *ctx.affine,
                                        **ctx.cfg)
                grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, *(next(grads) if t.requires_grad else None
                        for t in params), None, None, None, None, None)


def fused_patch_embed(images: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor, *, patch_size: int,
                      rescale: float = 1.0, mean=(0.0, 0.0, 0.0),
                      std=(1.0, 1.0, 1.0), out_dtype=torch.float32,
                      variant: str | None = None) -> torch.Tensor:
    """Normalise + patchify + project in one pass.

    Args:
      images: (B, H, W, C) uint8 or float32, NHWC.
      w: (P*P*C, D) float32 projection (HWIO conv kernel reshaped).
      bias: (D,) float32.
      variant: None (the rule: ``"wg"`` for uint8), or a variant of
        :func:`patch_embed_variants` for the images (else ValueError,
        before any launch); for measurement.
    Returns (B, N, D) in ``out_dtype`` (float32 or bfloat16). A CUDA input
    launches the kernel (and counts it in ``fused_patch_embed.launches``,
    and by kernel and variant in ``fused_patch_embed.launches_by_kernel``);
    a CPU input runs the plain version. When ``w`` or ``bias`` requires
    grad (and grad mode is on), the call goes through :class:`_PatchEmbed`,
    so their gradients are the plain version's."""
    c = images.shape[-1]
    a_vec, b_vec = _affine_on(images.device, patch_size, c, float(rescale),
                              tuple(float(x) for x in mean),
                              tuple(float(x) for x in std))
    _check(images, w, bias, a_vec, b_vec, patch_size, out_dtype)
    _check_variant(variant, images.dtype)
    if torch.is_grad_enabled() and (w.requires_grad or bias.requires_grad):
        out = _PatchEmbed.apply(images, w, bias, a_vec, b_vec, patch_size,
                                out_dtype, variant)
    else:
        out = _forward(images, w, bias, a_vec, b_vec, patch_size, out_dtype,
                       *_forced(variant))
    return out.reshape(images.shape[0], -1, w.shape[1])


fused_patch_embed.launches = 0
#: the same launches by kernel and variant (:func:`kernel_name`):
#: ``patch_embed_u8/wg``, ``patch_embed_u8/mma``, ``patch_embed_f32``
fused_patch_embed.launches_by_kernel = collections.Counter()
