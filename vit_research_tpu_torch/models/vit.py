"""Vision Transformer backbone as torch ``nn.Module``s.

Port of vit_research_tpu/models/vit.py for the embedding main path. The
parameter layout follows the JAX tree one to one (models/convert.py maps
between them), so imported or converted weights give the same function:

- ``patch_embed``: a (P*P*C, D) projection applied to patchified rows,
  i.e. the stride == kernel == P VALID convolution written as a matmul
  (a convolution on CUDA would run through cuDNN in TF32 by default);
- ``cls`` / ``pos_embedding`` with bilinear position resampling when the
  input grid differs from the configured one;
- pre-norm ``EncoderBlock``s (separate q/k/v projections, exact GELU);
- ``encoder_norm``, the ``token`` / ``gap`` / ``none`` poolers and the
  optional tanh ``pre_logits``; ``forward`` returns the endpoints dict.

Attention runs through ops/attention.py (the hand-written CUDA kernel on
a CUDA device) by default; the plain path serves attention-score outputs,
attention dropout in training and a non-f32 softmax, the same split as
the reference (vit.py:146-149). The reference's ``use_flash_attention``
flag is therefore not read. ToMe (``tome_r``), int8 GEMMs
(``gemm_quant``), ``remat`` and ``attn_layout='bthd'`` are not ported yet
and are refused.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vit_research_tpu_torch.utils.configs import ViTConfig
from vit_research_tpu_torch.ops import attention as attn_ops
from vit_research_tpu_torch.ops.patch_embed import patchify

# flax's lecun_normal / variance_scaling draws from a standard normal
# truncated to [-2, 2], rescaled by this constant so the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _dtype(name: str) -> torch.dtype:
    if name == "float32":
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown dtype {name!r}")


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def interpolate_pos_embedding(pos: torch.Tensor, grid_from: tuple,
                              grid_to: tuple, *,
                              has_cls: bool = True) -> torch.Tensor:
    """Bilinearly resample a learned (1, N[+1], D) position table to a new
    patch grid (align_corners=False, no antialiasing: jax.image.resize
    with antialias=False)."""
    grid_from, grid_to = tuple(grid_from), tuple(grid_to)
    if grid_from == grid_to:
        return pos
    cls_part = pos[:, :1] if has_cls else None
    grid_part = pos[:, 1:] if has_cls else pos
    d = grid_part.shape[-1]
    x = grid_part.reshape(1, grid_from[0], grid_from[1], d).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=grid_to, mode="bilinear", align_corners=False,
                      antialias=False)
    grid_part = x.permute(0, 2, 3, 1).reshape(1, grid_to[0] * grid_to[1], d)
    if cls_part is not None:
        return torch.cat([cls_part, grid_part], dim=1)
    return grid_part


class PatchEmbed(nn.Module):
    """Patch projection as a matmul over patch rows: ``weight`` is
    (P*P*C, D), the HWIO conv kernel reshaped. Its dtype is the model's
    compute dtype (``forward`` casts the images to it)."""

    def __init__(self, patch_size: int, channels: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        k = patch_size * patch_size * channels
        self.weight = nn.Parameter(torch.empty(k, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) float -> (B, N, D)."""
        rows = patchify(images, self.patch_size)
        return rows @ self.weight + self.bias


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dropout_rate: float = 0.0,
                 gelu_approximate: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.dropout = nn.Dropout(dropout_rate)
        self.gelu_approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x):
        x = F.gelu(self.fc1(x), approximate=self.gelu_approximate)
        x = self.dropout(x)
        return self.dropout(self.fc2(x))


class MultiHeadSelfAttention(nn.Module):
    """MHA with separate q/k/v projections. ``query``/``key``/``value`` are
    (H*dh, D) ``nn.Linear``s, ``out`` maps H*dh back to D."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.dropout = nn.Dropout(dropout_rate)
        self.softmax_dtype = softmax_dtype

    def forward(self, x, output_scores: bool = False):
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h

        def heads(lin):  # (B, T, D) -> (B, H, T, dh)
            return lin(x).reshape(b, t, h, dh).transpose(1, 2).contiguous()

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scores = None
        needs_plain = (output_scores
                       or self.softmax_dtype != torch.float32
                       or (self.training and self.dropout.p > 0.0))
        if needs_plain:
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (dh ** -0.5)
            probs = torch.softmax(s.to(self.softmax_dtype), dim=-1)
            if output_scores:
                scores = probs.to(torch.float32)
            probs = self.dropout(probs)
            o = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)
        else:
            o = attn_ops.multi_head_attention(q, k, v)
        o = o.transpose(1, 2).reshape(b, t, d)
        return self.out(o), scores


class EncoderBlock(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 layer_norm_eps: float = 1e-6,
                 gelu_approximate: bool = False,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = MultiHeadSelfAttention(dim, num_heads,
                                           attention_dropout_rate,
                                           softmax_dtype)
        self.ln2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = MlpBlock(dim, mlp_dim, dropout_rate, gelu_approximate)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x, output_scores: bool = False):
        y, scores = self.attn(self.ln1(x), output_scores)
        x = x + self.dropout(y)
        return x + self.mlp(self.ln2(x)), scores


class VisionTransformer(nn.Module):
    """ViT backbone configured by a ``ViTConfig`` (utils/configs.py, the
    reference's fields). Parameters
    are created in f32 and cast with ``.to(dtype)`` by the caller for bf16
    compute (``config.dtype``); LayerNorms run in the activations' dtype."""

    def __init__(self, config: ViTConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        for flag, bad in (("tome_r", bool(c.tome_r)),
                          ("gemm_quant", c.gemm_quant is not None),
                          ("remat", c.remat),
                          ("attn_layout", c.attn_layout != "bhtd")):
            if bad:
                raise NotImplementedError(
                    f"ViTConfig.{flag} is not ported to the torch backbone "
                    "yet")
        if c.pooler not in ("token", "gap", "none"):
            raise ValueError(f"unknown pooler {c.pooler!r}")
        self.config = c
        self.compute_dtype = _dtype(c.dtype)
        sm_dtype = _dtype(c.softmax_dtype)
        d = c.hidden_size
        self.patch_embed = PatchEmbed(c.patch_size, 3, d)
        self.cls = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, c.num_patches + 1, d))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, c.num_heads, c.mlp_dim,
                         dropout_rate=c.dropout_rate,
                         attention_dropout_rate=c.attention_dropout_rate,
                         layer_norm_eps=c.layer_norm_eps,
                         gelu_approximate=c.gelu_approximate,
                         softmax_dtype=sm_dtype)
            for _ in range(c.num_layers))
        self.encoder_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.pre_logits = (nn.Linear(d, c.representation_size)
                           if c.representation_size is not None else None)
        self.input_dropout = nn.Dropout(c.dropout_rate)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init with the reference's initialisers: cls zeros, pos
        trunc-normal(0.02), dense and patch kernels lecun-normal with zero
        bias, LayerNorm ones/zeros. ``torch.Generator`` and ``jax.random``
        draw different numbers, so equal weights across the two packages
        come from models/convert.py, not from a shared seed."""
        nn.init.zeros_(self.cls)
        nn.init.trunc_normal_(self.pos_embedding, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        _lecun_normal_(self.patch_embed.weight,
                       self.patch_embed.weight.shape[0], generator)
        nn.init.zeros_(self.patch_embed.bias)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, images: torch.Tensor) -> dict:
        """(B, H, W, 3) normalised float images -> endpoints dict."""
        p = self.config.patch_size
        _, h, w, _ = images.shape
        x = self.patch_embed(images.to(self.compute_dtype))
        return self.encode_patch_tokens(x, (h // p, w // p))

    def encode_patch_tokens(self, x: torch.Tensor, grid) -> dict:
        """Everything after the patch projection: (B, N, D) tokens on a
        ``grid`` of patches -> endpoints dict. Direct entry point for the
        fused patch-embed kernel (ops/patch_embed.py)."""
        c = self.config
        dtype = self.compute_dtype
        b = x.shape[0]
        x = x.to(dtype)
        x = torch.cat([self.cls.to(dtype).expand(b, -1, -1), x], dim=1)
        pos = interpolate_pos_embedding(self.pos_embedding, c.grid,
                                        tuple(grid), has_cls=True)
        x = self.input_dropout(x + pos.to(dtype))

        endpoints = {"tokens_before_encoder": x}
        all_scores = []
        for block in self.blocks:
            x, scores = block(x, c.output_attention_scores)
            if scores is not None:
                all_scores.append(scores)
        x = self.encoder_norm(x)
        endpoints["encoded_tokens"] = x

        if c.pooler == "token":
            pooled = x[:, 0]
        elif c.pooler == "gap":
            pooled = x[:, 1:].mean(dim=1)
        else:
            pooled = x
        endpoints["pooled"] = pooled
        if self.pre_logits is not None and c.pooler != "none":
            endpoints["pre_logits"] = torch.tanh(self.pre_logits(pooled))
        else:
            endpoints["pre_logits"] = pooled
        if all_scores:
            endpoints["attention_scores"] = torch.stack(all_scores, dim=1)
        return endpoints


def init_vit(config: ViTConfig, *, seed: int = 0,
             device) -> VisionTransformer:
    """Seeded-init contract of the port: (config, seed) -> deterministic
    weights on ``device`` (drawn on the CPU from a ``torch.Generator``, so
    the same seed gives the same weights on every device). The model is
    cast to ``config.dtype`` and put in eval mode."""
    from vit_research_tpu_torch.device import resolve_device

    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = VisionTransformer(config, generator=gen)
    return model.to(device=resolve_device(device),
                    dtype=_dtype(config.dtype)).eval()
