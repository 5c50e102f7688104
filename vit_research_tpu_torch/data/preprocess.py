"""Frame preprocessing on the host: decode, resize, grayscale, normalise.

Port of vit_research_tpu/data/preprocess.py. Frames are decoded with PIL
(or, with ``use_native``, the libjpeg decoder of native/jpeg.py) and
resized to the model's input size as uint8; the affine normalise is
folded into the patch-embed kernel on the device (ops/patch_embed.py), so
normalised f32 frames never exist in host memory on the embedding path
(:func:`normalize_host` is the reference-exact host version, for parity
checks).

Two regimes, as in the reference:

1. **HF-ViT regime** (p16 @ 224): ViTImageProcessor semantics — resize to
   224x224 bilinear, rescale 1/255, normalize mean=std=0.5
   (reference: nba_proj/train/training.py:47-60).
2. **Random-ViT regime** (p32 @ 432x768): resize INTER_AREA
   (reference: nba_proj/loader.py:4-8); cv2 is used when installed, else
   the exact area-averaging arithmetic below.
"""

from __future__ import annotations

import concurrent.futures as _fut
import functools
import os
import threading
from dataclasses import dataclass

import numpy as np

HF_SIZE = (224, 224)
FRAME_SIZE = (432, 768)  # (H, W) random-ViT regime
IMAGENET_HF_MEAN = (0.5, 0.5, 0.5)
IMAGENET_HF_STD = (0.5, 0.5, 0.5)


#: ITU-R BT.601 luminance weights — the constants the reference hardcodes
#: in both of its grayscale drift variants.
LUMA_WEIGHTS = (0.2989, 0.5870, 0.1140)


@dataclass(frozen=True)
class PreprocessSpec:
    """Everything the device kernel needs to finish preprocessing."""

    size: tuple = HF_SIZE  # (H, W) after host resize
    rescale: float = 1.0 / 255.0
    mean: tuple = IMAGENET_HF_MEAN
    std: tuple = IMAGENET_HF_STD
    interpolation: str = "bilinear"  # 'bilinear' | 'area'
    #: Embed grayscale-converted frames (luminance replicated across the
    #: 3 channels), applied at embed time on the device (parallel/embed.py).
    grayscale: bool = False


HF_VIT_SPEC = PreprocessSpec()
# do_rescale=False variant (reference: nba_proj/train/training.py:38 feeds
# 0..1 floats and disables the processor's own rescale).
HF_VIT_SPEC_NO_RESCALE = PreprocessSpec(rescale=1.0)
# Random-ViT regime: no normalization; raw 0..255 (writer scripts) or 0..1
# (tf.data path).
RANDOM_VIT_SPEC_RAW = PreprocessSpec(
    size=FRAME_SIZE, rescale=1.0, mean=(0, 0, 0), std=(1, 1, 1),
    interpolation="area")
RANDOM_VIT_SPEC_UNIT = PreprocessSpec(
    size=FRAME_SIZE, rescale=1.0 / 255.0, mean=(0, 0, 0), std=(1, 1, 1),
    interpolation="area")
# SigLIP's processor (google/siglip-so400m-patch14-384): 384x384, rescale
# 1/255, mean and std 0.5 (HF_VIT_SPEC's constants). Its resize is bicubic;
# the host resize here is bilinear (frames of another size only).
SIGLIP_SPEC = PreprocessSpec(size=(384, 384))


def decode_image(path: str) -> np.ndarray:
    """JPEG/PNG -> RGB uint8 (H, W, 3)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@functools.lru_cache(maxsize=16)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) fractional pixel-area averaging weights — the exact
    arithmetic cv2 INTER_AREA uses for downscaling: output cell i averages
    input over [i*s, (i+1)*s), s = n_in/n_out, with fractional edge pixels
    weighted by their overlap."""
    s = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        k0, k1 = int(np.floor(lo)), int(min(np.ceil(hi), n_in))
        for k in range(k0, k1):
            w[i, k] = min(hi, k + 1) - max(lo, k)
    return (w / s).astype(np.float32)


def resize_area(img: np.ndarray, size: tuple) -> np.ndarray:
    """Exact INTER_AREA downscale (fractional pixel-area averaging,
    cv2-equivalent arithmetic to within fixed-point rounding). Upscaling
    falls back to bilinear like cv2 does for INTER_AREA."""
    h, w = size
    hi, wi = img.shape[:2]
    if h > hi or w > wi:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.BILINEAR))
    wy = _area_weights(hi, h)
    wx = _area_weights(wi, w)
    t = np.tensordot(wy, img.astype(np.float32), axes=(1, 0))  # (h, wi, C)
    out = np.tensordot(t, wx, axes=(1, 1))  # (h, C, w)
    out = np.moveaxis(out, -1, 1)
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def resize_frame(img: np.ndarray, size: tuple,
                 interpolation: str = "bilinear") -> np.ndarray:
    """Resize RGB uint8 to (H, W). 'area' matches cv2 INTER_AREA
    (reference: nba_proj/loader.py:7); 'bilinear' matches PIL/HF."""
    h, w = size
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if interpolation == "area":
        try:
            import cv2

            return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        except ImportError:
            return resize_area(img, size)
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def preprocess_frame(path_or_img, size: tuple = FRAME_SIZE,
                     interpolation: str = "area") -> np.ndarray:
    """Single-frame host preprocess -> RGB uint8 (H, W, 3)
    (reference behavior: nba_proj/loader.py:4-8)."""
    img = (decode_image(path_or_img)
           if isinstance(path_or_img, (str, os.PathLike))
           else np.asarray(path_or_img))
    return resize_frame(img, size, interpolation)


def load_frames(paths, spec: PreprocessSpec = HF_VIT_SPEC,
                num_workers: int = 8, use_native: bool = False) -> np.ndarray:
    """Parallel decode+resize -> (N, H, W, 3) uint8 batch, on a thread
    pool (PIL releases the GIL while it decodes).

    ``use_native=True`` routes JPEG files through the C decoder
    (native/jpeg_fast.c: libjpeg DCT-scaled decode fused with the resize)
    when it is available, as the reference does; its bilinear sampling is
    not antialiased, so the default (PIL) stays the HF-parity path."""
    if use_native:
        from vit_research_tpu_torch import native

        if native.is_available() and all(
                str(p).lower().endswith((".jpg", ".jpeg")) for p in paths):
            return native.decode_batch(list(paths), spec.size,
                                       num_workers=num_workers)
    out = np.empty((len(paths), spec.size[0], spec.size[1], 3), np.uint8)

    def work(i_path):
        i, path = i_path
        out[i] = preprocess_frame(path, spec.size, spec.interpolation)

    if num_workers <= 1 or len(paths) <= 1:
        for item in enumerate(paths):
            work(item)
    else:
        # Reused across calls: load_frames runs once per batch in the
        # embedding loop, so per-call pool spawn/join is pure churn.
        list(_decode_pool(num_workers).map(work, enumerate(paths)))
    return out


_decode_pools: dict[int, "_fut.ThreadPoolExecutor"] = {}
_decode_pools_lock = threading.Lock()


def _decode_pool(num_workers: int) -> "_fut.ThreadPoolExecutor":
    with _decode_pools_lock:
        pool = _decode_pools.get(num_workers)
        if pool is None:
            pool = _fut.ThreadPoolExecutor(
                num_workers, thread_name_prefix="vrt-decode")
            _decode_pools[num_workers] = pool
        return pool


def to_grayscale_3ch(frames: np.ndarray) -> np.ndarray:
    """Luminance grayscale replicated across 3 channels: uint8 in ->
    clip + truncating cast -> uint8 out; float in -> float32 out,
    unclipped (the reference's two drift variants)."""
    w = np.asarray(LUMA_WEIGHTS, np.float32)
    gray = frames.astype(np.float32) @ w
    if frames.dtype == np.uint8:
        # astype truncates, exactly like the reference's clip+astype.
        gray = np.clip(gray, 0, 255).astype(np.uint8)
    return np.stack([gray, gray, gray], axis=-1)


def normalize_host(batch_u8: np.ndarray, spec: PreprocessSpec) -> np.ndarray:
    """Reference-exact host normalisation (the parity path; the embedding
    path folds it into ops/patch_embed.py::fused_patch_embed)."""
    if spec.grayscale:
        batch_u8 = to_grayscale_3ch(batch_u8)
    x = batch_u8.astype(np.float32) * spec.rescale
    return (x - np.asarray(spec.mean, np.float32)) / np.asarray(
        spec.std, np.float32)
