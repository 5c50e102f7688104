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

Beyond the reference, the backbone takes SigLIP's vision tower (its
configuration: models/hf_import.py::SIGLIP_SO400M_P14_384): no class
token (``class_token=False``: the position table has one row a patch),
tanh GELU, and the ``map`` pooler, a multihead attention-pooling head
(:class:`MAPHead`) after ``encoder_norm``. The JAX package has no such
model, so models/convert.py refuses both settings.

Attention runs through ops/attention.py (the hand-written CUDA kernel on
a CUDA device) by default; the plain path serves attention-score outputs,
attention dropout in training and a non-f32 softmax, the same split as
the reference (vit.py:146-149), and heads wider than the kernel's widest
compiled width (dh > 192, :func:`head_too_wide_for_kernel`). The
reference's ``use_flash_attention`` flag is therefore not read.

The fast profile's two backbone options, off the parity path:

- ``tome_r``: ``ToMeEncoderBlock``s merge ``r`` tokens a layer
  (ops/tome.py); their attention takes ``log(sizes)`` as the kernel's key
  bias (the reference runs that attention on XLA). The ``gap`` pooler
  weights tokens by size, and a ``token_sizes`` endpoint is returned.
- ``gemm_quant``: the q/k/v/out and MLP products run as int8 GEMMs
  (ops/quant.py), dynamic (``'int8'``) or with calibrated static
  activation scales (``'int8-static'`` + ``gemm_quant_scales``). The
  layers keep their ``nn.Linear`` parameters, so the ``state_dict`` is
  the plain model's and the same converted weights load.

Options of the reference's backbone that change how, not what, it
computes:

- ``remat``: each encoder block runs under
  ``torch.utils.checkpoint`` (the reference's ``nn.remat``), so a backward
  recomputes the block's activations instead of keeping them. The
  recompute replays the block's dropout masks from the state its
  :class:`Dropout` generators had in the forward (:func:`_checkpointed`).
- ``attn_layout='bthd'``: the attention einsums read q, k and v in the
  projections' (B, T, H, dh) order. As in the reference, that layout
  takes the plain path, kernel or not.

The heads (models/heads.py) run these blocks in a compute dtype over f32
parameters (``EncoderBlock(dtype=torch.bfloat16)``), flax's rule: a dense
layer casts its input and its f32 weight to the compute dtype, a
LayerNorm promotes to f32, and the residual stream keeps the dtype the
arithmetic gives it. The backbone's own bf16 route casts the whole model
(``init_vit``), and its LayerNorms run in bf16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_research_tpu_torch.utils.configs import ViTConfig
from vit_research_tpu_torch.ops import attention as attn_ops
from vit_research_tpu_torch.ops import linear as linear_ops
from vit_research_tpu_torch.ops import quant
from vit_research_tpu_torch.ops.patch_embed import patchify
from vit_research_tpu_torch.ops.tome import bipartite_merge
from vit_research_tpu_torch.utils import profiling

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


class Dropout(nn.Dropout):
    """Dropout whose masks come from ``self.generator`` when it is set (a
    ``torch.Generator`` on the activations' device; the training loops
    seed one per epoch, so a resumed run replays its masks), else from
    torch's default generator. Drops as flax does: ``where(keep, x /
    (1 - p), 0)`` with ``keep ~ Bernoulli(1 - p)``, ``1 - p`` rounded to
    x's dtype as JAX rounds the Python float (bf16: 0.9 -> 0.8984375)."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            keep_prob, generator=self.generator).to(torch.bool)
        return torch.where(keep, x / attn_ops.weak_scalar(keep_prob, x.dtype),
                           0.0)


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Point every :class:`Dropout` of ``module`` at ``generator`` (None:
    torch's default generator)."""
    for mod in module.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def _dense(lin: nn.Linear, x: torch.Tensor, qdg=None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``lin(x)``; its int8 product through ``qdg`` (ops/quant.py) plus the
    bias (the reference injects its int8 ``dot_general`` into the same
    Dense layers, which add the bias after the product); or, with a
    compute ``dtype``, flax's ``Dense(dtype=...)``: input, weight and bias
    cast to ``dtype``, the product rounded to it, then the bias added. An
    f32 inference product on the card that ``ops/linear.py::route`` sends
    to the kernel runs on the tensor cores (3xTF32, f32 accuracy)."""
    if linear_ops.route(x, lin.weight, lin.bias, qdg=qdg,
                        dtype=dtype) == "kernel":
        return linear_ops.linear(x, lin.weight, lin.bias)
    if qdg is not None:
        return qdg(x, lin.weight) + lin.bias
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


def _norm(ln: nn.LayerNorm, x: torch.Tensor,
          dtype: torch.dtype | None) -> torch.Tensor:
    """``ln(x)``; with a compute ``dtype``, flax's LayerNorm without one:
    it promotes to its f32 parameters, so the input is taken in f32 and
    the output is f32."""
    return ln(x if dtype is None else x.to(torch.float32))


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
                 gelu_approximate: bool = False, dot_general=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.dropout = Dropout(dropout_rate)
        self.gelu_approximate = "tanh" if gelu_approximate else "none"
        self.dot_general = dot_general  # None, or an ops/quant.py product
        self.dtype = dtype  # compute dtype over f32 weights (None: theirs)

    def forward(self, x):
        x = F.gelu(_dense(self.fc1, x, self.dot_general, self.dtype),
                   approximate=self.gelu_approximate)
        x = self.dropout(x)
        return self.dropout(_dense(self.fc2, x, self.dot_general,
                                   self.dtype))


def head_too_wide_for_kernel(dh: int) -> bool:
    """The one width rule of the attention routing: kernel B takes head
    widths up to its widest compiled one (192; a width between two
    compiled ones runs zero-padded, ops/attention.py), so a wider head
    (dh > 192, e.g. 768 wide with 2 heads) takes the plain path. The
    reference's Pallas kernel takes any width (its block holds the full
    dh); B at dh > 192 is a width the kernel still has to take."""
    return attn_ops.kernel_head_dim(dh) is None


class MultiHeadSelfAttention(nn.Module):
    """MHA with separate q/k/v projections. ``query``/``key``/``value`` are
    (H*dh, D) ``nn.Linear``s, ``out`` maps H*dh back to D. ``attn_layout``
    is ``'bhtd'`` (the kernel's route) or ``'bthd'`` (einsums on the
    projections' order, always the plain path)."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 softmax_dtype: torch.dtype = torch.float32,
                 dot_general=None, dtype: torch.dtype | None = None,
                 attn_layout: str = "bhtd"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} "
                             "heads")
        if attn_layout not in ("bhtd", "bthd"):
            raise ValueError(f"attn_layout must be 'bhtd' or 'bthd', got "
                             f"{attn_layout!r}")
        self.num_heads = num_heads
        self.dtype = dtype  # compute dtype over f32 weights (None: theirs)
        self.attn_layout = attn_layout
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.dropout = Dropout(dropout_rate)
        self.softmax_dtype = softmax_dtype
        self.dot_general = dot_general  # None, or an ops/quant.py product

    def forward(self, x, output_scores: bool = False, log_size=None,
                output_metric: bool = False):
        """``log_size``: optional (B, T) f32 key bias (ToMe's proportional
        attention: a merged token keeps its constituents' attention
        mass). ``output_metric`` also returns the head-averaged keys
        (B, T, dh), ToMe's matching features, as a third value."""
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h

        bthd = self.attn_layout == "bthd"

        # (B, T, D) -> (B, T, H, dh), the projection's order. 'bhtd' sees
        # it as the (B, H, T, dh) view: the kernel reads that through its
        # strides and writes its output in the same order, so no layout
        # copy is made.
        def heads(lin):
            y = _dense(lin, x, self.dot_general, self.dtype).reshape(
                b, t, h, dh)
            return y if bthd else y.transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scores = None
        needs_plain = (output_scores or bthd
                       or self.softmax_dtype != torch.float32
                       or (self.training and self.dropout.p > 0.0)
                       or head_too_wide_for_kernel(dh))
        if needs_plain:
            s = torch.einsum("bqhd,bkhd->bhqk" if bthd else
                             "bhqd,bhkd->bhqk", q, k) \
                * attn_ops.weak_scalar(dh ** -0.5, q.dtype)
            if log_size is not None:
                s = s + log_size[:, None, None, :].to(s.dtype)
            probs = torch.softmax(s.to(self.softmax_dtype), dim=-1)
            if output_scores:
                scores = probs.to(torch.float32)
            probs = self.dropout(probs)
            o = torch.einsum("bhqk,bkhd->bqhd" if bthd else
                             "bhqk,bhkd->bhqd", probs.to(q.dtype), v)
        else:
            o = attn_ops.multi_head_attention(q, k, v, key_bias=log_size)
        if not bthd:
            o = o.transpose(1, 2)
        out = _dense(self.out, o.reshape(b, t, d), self.dot_general,
                     self.dtype)
        if output_metric:
            return out, scores, k.mean(dim=2 if bthd else 1)
        return out, scores


class EncoderBlock(nn.Module):
    """Pre-norm transformer block. ``dtype``: a compute dtype over the f32
    parameters (flax's rule, see the module docstring); None computes in
    the parameters' dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0,
                 layer_norm_eps: float = 1e-6,
                 gelu_approximate: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 dot_general=None, dtype: torch.dtype | None = None,
                 attn_layout: str = "bhtd"):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = MultiHeadSelfAttention(dim, num_heads,
                                           attention_dropout_rate,
                                           softmax_dtype, dot_general, dtype,
                                           attn_layout)
        self.ln2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = MlpBlock(dim, mlp_dim, dropout_rate, gelu_approximate,
                            dot_general, dtype)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, output_scores: bool = False):
        y, scores = self.attn(_norm(self.ln1, x, self.dtype), output_scores)
        x = x + self.dropout(y)
        return x + self.mlp(_norm(self.ln2, x, self.dtype)), scores


class ToMeEncoderBlock(EncoderBlock):
    """EncoderBlock that merges ``r`` tokens after its attention (ToMe,
    ops/tome.py). Same submodules as EncoderBlock, so the same weights
    load into either; only the forward differs."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, r: int,
                 **kwargs):
        super().__init__(dim, num_heads, mlp_dim, **kwargs)
        self.r = r

    def forward(self, x, sizes):
        y, _, metric = self.attn(self.ln1(x), log_size=torch.log(sizes),
                                 output_metric=True)
        x = x + self.dropout(y)
        x, sizes = bipartite_merge(x, metric, sizes, self.r)
        return x + self.mlp(self.ln2(x)), sizes


class MAPHead(nn.Module):
    """Multihead attention pooling (SigLIP's
    ``SiglipMultiheadAttentionPoolingHead``): a learned probe (1, 1, D)
    is the one query of multihead attention over the tokens, then
    ``y = a + MLP(LayerNorm(a))`` on the attention output ``a``; the
    pooled vector is that one row.

    q/k/v/out are separate ``nn.Linear``s (a packed in-projection is split
    at import, models/hf_import.py), applied through :func:`_dense`, so
    the keys and values over B x T rows take ops/linear.py's kernel where
    its rule admits them. The probe's query does not depend on the batch:
    it is projected once. The one-query softmax runs in plain torch
    (kernel B is self-attention; this product is 4 T D operations a
    frame), in f32."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 layer_norm_eps: float = 1e-6,
                 gelu_approximate: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} "
                             "heads")
        self.num_heads = num_heads
        self.probe = nn.Parameter(torch.zeros(1, 1, dim))
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = MlpBlock(dim, mlp_dim, gelu_approximate=gelu_approximate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) tokens -> (B, D) pooled."""
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        with profiling.span("vit.map_pool", rows=b):
            q = _dense(self.query, self.probe[0].to(x.dtype)).reshape(h, dh)
            k = _dense(self.key, x).reshape(b, t, h, dh)
            v = _dense(self.value, x).reshape(b, t, h, dh)
            s = torch.einsum("hd,bthd->bht", q, k) * attn_ops.weak_scalar(
                dh ** -0.5, x.dtype)
            p = torch.softmax(s.to(torch.float32), dim=-1).to(x.dtype)
            a = _dense(self.out, torch.einsum("bht,bthd->bhd", p,
                                              v).reshape(b, d))
            return a + self.mlp(self.norm(a))


class VisionTransformer(nn.Module):
    """ViT backbone configured by a ``ViTConfig`` (utils/configs.py, the
    reference's fields). Parameters
    are created in f32 and cast with ``.to(dtype)`` by the caller for bf16
    compute (``config.dtype``); LayerNorms run in the activations' dtype."""

    def __init__(self, config: ViTConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        if c.tome_r and (c.remat or c.output_attention_scores):
            raise ValueError(
                "tome_r is incompatible with remat (an inference-speed "
                "knob) and with output_attention_scores (per-layer "
                "score shapes differ once tokens merge)")
        if c.pooler not in ("token", "gap", "map", "none"):
            raise ValueError(f"unknown pooler {c.pooler!r}")
        #: the config's ``class_token`` (the JAX package's ViTConfig, which
        #: the tests hand the port too, has none: a class token)
        self.class_token = getattr(c, "class_token", True)
        if not self.class_token and (c.pooler == "token" or c.tome_r):
            raise ValueError(
                "class_token=False takes the 'gap', 'map' or 'none' pooler "
                "and no tome_r (the token pooler and ToMe's protected "
                "first token are the class token)")
        self.config = c
        self.compute_dtype = _dtype(c.dtype)
        sm_dtype = _dtype(c.softmax_dtype)
        #: the int8 product of the dense layers (None: the float ones)
        self.dot_general = _quant_dot_general(c)
        d = c.hidden_size
        self.patch_embed = PatchEmbed(c.patch_size, 3, d)
        self.cls = (nn.Parameter(torch.zeros(1, 1, d)) if self.class_token
                    else None)
        self.pos_embedding = nn.Parameter(
            torch.empty(1, c.num_patches + int(self.class_token), d))
        block_kw = dict(dropout_rate=c.dropout_rate,
                        attention_dropout_rate=c.attention_dropout_rate,
                        layer_norm_eps=c.layer_norm_eps,
                        gelu_approximate=c.gelu_approximate,
                        softmax_dtype=sm_dtype,
                        dot_general=self.dot_general)
        self.blocks = nn.ModuleList(
            ToMeEncoderBlock(d, c.num_heads, c.mlp_dim, c.tome_r, **block_kw)
            if c.tome_r else EncoderBlock(d, c.num_heads, c.mlp_dim,
                                          attn_layout=c.attn_layout,
                                          **block_kw)
            for _ in range(c.num_layers))
        self.encoder_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.head = (MAPHead(d, c.num_heads, c.mlp_dim,
                             layer_norm_eps=c.layer_norm_eps,
                             gelu_approximate=c.gelu_approximate)
                     if c.pooler == "map" else None)
        self.pre_logits = (nn.Linear(d, c.representation_size)
                           if c.representation_size is not None else None)
        self.input_dropout = Dropout(c.dropout_rate)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init with the reference's initialisers: cls zeros, pos
        (and the MAP head's probe) trunc-normal(0.02), dense and patch kernels lecun-normal with zero
        bias, LayerNorm ones/zeros. ``torch.Generator`` and ``jax.random``
        draw different numbers, so equal weights across the two packages
        come from models/convert.py, not from a shared seed."""
        if self.cls is not None:
            nn.init.zeros_(self.cls)
        nn.init.trunc_normal_(self.pos_embedding, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        if self.head is not None:
            nn.init.trunc_normal_(self.head.probe, std=0.02, a=-0.04, b=0.04,
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
        if isinstance(self.dot_general, quant.StaticInt8DotGeneral):
            self.dot_general.reset()  # one scale per site, per forward
        x = x.to(dtype)
        if self.class_token:
            x = torch.cat([self.cls.to(dtype).expand(b, -1, -1), x], dim=1)
        pos = interpolate_pos_embedding(self.pos_embedding, c.grid,
                                        tuple(grid), has_cls=self.class_token)
        x = self.input_dropout(x + pos.to(dtype))

        endpoints = {"tokens_before_encoder": x}
        all_scores = []
        sizes = None
        if c.tome_r:
            sizes = torch.ones(x.shape[:2], dtype=torch.float32,
                               device=x.device)
            for block in self.blocks:
                x, sizes = block(x, sizes)
        else:
            for block in self.blocks:
                if c.remat and torch.is_grad_enabled():
                    x, scores = _checkpointed(block, x,
                                              c.output_attention_scores)
                else:
                    x, scores = block(x, c.output_attention_scores)
                if scores is not None:
                    all_scores.append(scores)
        x = self.encoder_norm(x)
        endpoints["encoded_tokens"] = x
        if sizes is not None:
            endpoints["token_sizes"] = sizes

        if c.pooler == "token":
            pooled = x[:, 0]
        elif c.pooler == "map":
            pooled = self.head(x)
        elif c.pooler == "gap":
            if sizes is None:
                pooled = x[:, int(self.class_token):].mean(dim=1)
            else:  # a merged token stands for several: weight by size
                w = sizes[:, 1:, None].to(x.dtype)
                pooled = (x[:, 1:] * w).sum(dim=1) / w.sum(dim=1)
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


def _checkpointed(block: nn.Module, *args):
    """``block(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward. ``preserve_rng_state``
    replays torch's default generators only, and a :class:`Dropout` may
    draw from a generator of its own: the recompute would draw new masks
    and the gradients would be wrong, with no error. So the recompute
    first sets every such generator to the state it had when the forward
    ran, and afterwards gives it back the state it has at the backward."""
    gens = list({id(m.generator): m.generator for m in block.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())
    at_forward: list = []

    @contextlib.contextmanager
    def forward_ctx():
        at_forward[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (forward_ctx(), recompute_ctx()))


def _quant_dot_general(c: ViTConfig):
    """The int8 product for ``c.gemm_quant`` (None for float GEMMs). A
    static product with no scales is built too: it records under
    ops/quant.py::calibration_mode and raises outside it."""
    if c.gemm_quant not in (None, "int8", "int8-static"):
        raise ValueError(f"unknown gemm_quant {c.gemm_quant!r}")
    if c.gemm_quant == "int8":
        return quant.int8_dot_general
    if c.gemm_quant is None:
        return None
    expected = 6 * c.num_layers  # q, k, v, out, fc1, fc2 per block
    if c.gemm_quant_scales and len(c.gemm_quant_scales) != expected:
        # too few would run out mid-forward; too many would silently
        # apply another architecture's calibration
        raise ValueError(
            f"gemm_quant_scales has {len(c.gemm_quant_scales)} "
            f"entries but this {c.num_layers}-layer model has "
            f"{expected} dense dot sites — the calibration came "
            "from a different architecture; re-calibrate with "
            "the same flags")
    return quant.StaticInt8DotGeneral(c.gemm_quant_scales)


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
