"""Operations and bytes from shapes, the card's peaks, and the shares of
a peak or a roofline that the per-layer metrics report.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W power
limit (dense rates): the run writes the card's own limit beside them. An
f32 configuration is held against the TF32 tensor-core peak, not the
67 TFLOP/s of the CUDA cores: f32-accurate products can be had on the
tensor cores by splitting operands (the port's kernels A and B already
do so), and a share of the lower peak would pass 100% once the GEMMs
move there.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def image_hw(cfg: dict) -> tuple:
    """(H, W) of a configuration's ``image_size``: one number (square, as
    Hugging Face's configs give it) or [H, W]."""
    size = cfg["image_size"]
    return (size, size) if isinstance(size, int) else tuple(size)


def tokens(cfg: dict) -> int:
    """T: the patches of the (cropped) image, and the class token."""
    h, w = image_hw(cfg)
    p = cfg["patch_size"]
    return (h // p) * (w // p) + 1


def vit_flops_per_frame(t: int = 197, d: int = 768, layers: int = 12,
                        mlp: int = 3072, patch_in: int = 16 * 16 * 3) -> float:
    """Analytic forward FLOPs (2 x MACs) of one ViT frame: the patch
    projection, each layer's q/k/v/out projections, the attention score
    and mix products, and the two MLP products (bench.py's arithmetic,
    with T and the patch as arguments). LayerNorm, GELU, softmax and
    adds are left out. ViT-B/16 at 224: 35.1 GFLOP."""
    patch = (t - 1) * d * patch_in
    per_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * mlp
    return 2.0 * (patch + layers * per_layer)


def config_flops_per_frame(cfg: dict) -> float:
    return vit_flops_per_frame(tokens(cfg), cfg["hidden_size"],
                               cfg["num_hidden_layers"],
                               cfg["intermediate_size"],
                               cfg["patch_size"] ** 2 * cfg["num_channels"])


def gemm_bound_s(m: int, k: int, n: int, dtype: str) -> float:
    """The least time of one (m, k) x (k, n) product with a bias: its
    operations over the peak against its bytes (the input, the weight
    and the bias read once, the output written once) over HBM."""
    size = ITEMSIZE[dtype]
    flops = 2.0 * m * k * n
    nbytes = (m * k + k * n + n + m * n) * size
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def linear_bound_s(cfg: dict, batch: int) -> float:
    """The encoder GEMMs of one batch (q, k, v, out, fc1, fc2 in every
    layer), each at its own bound."""
    m = batch * tokens(cfg)
    d, mlp = cfg["hidden_size"], cfg["intermediate_size"]
    dt = cfg["dtype"]
    layer = (4 * gemm_bound_s(m, d, d, dt) + gemm_bound_s(m, d, mlp, dt)
             + gemm_bound_s(m, mlp, d, dt))
    return cfg["num_hidden_layers"] * layer


def attention_bound_s(batch: int, heads: int, t: int, dh: int,
                      dtype: str) -> float:
    """One call of kernel B: S = Q K^T and O = P V (4 B H T^2 dh
    operations) against q, k and v read once and the output written once
    (PERF.md's byte count)."""
    flops = 4.0 * batch * heads * t * t * dh
    nbytes = 4.0 * batch * heads * t * dh * ITEMSIZE[dtype]
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def config_attention_bound_s(cfg: dict, batch: int) -> float:
    """Every layer's call of kernel B for one batch."""
    heads = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // heads
    return cfg["num_hidden_layers"] * attention_bound_s(
        batch, heads, tokens(cfg), dh, cfg["dtype"])


def query_flops(q: int, n: int, d: int) -> float:
    return 2.0 * q * n * d


def query_bound_s(q: int, n: int, d: int, dtype: str = "float32") -> float:
    """One exact query batch, whatever computes its top-k: the (q, d) x
    (d, n) product over the peak against reading the (n, d) corpus once
    over HBM."""
    return max(query_flops(q, n, d) / PEAK_FLOPS[dtype],
               n * d * ITEMSIZE[dtype] / HBM_BYTES_PER_S)


def share_pct(bound_s: float, time_s: float) -> float | None:
    """``bound_s`` as a percentage of ``time_s``; None where no time was
    measured. Never clipped: a reading over 100% means the operations or
    bytes are counted too high, or the time leaves out part of the
    work."""
    if not time_s or time_s <= 0:
        return None
    return 100.0 * bound_s / time_s


def mfu_pct(flops: float, seconds: float, dtype: str) -> float | None:
    """Achieved operations per second as a percentage of the peak."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS[dtype]


def over_peak(name: str, value: float | None) -> bool:
    """A share of a roofline or of a peak that reads above 100%."""
    return (value is not None and ("roofline" in name or "mfu" in name)
            and value > 100.0)
