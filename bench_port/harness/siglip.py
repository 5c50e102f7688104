"""SigLIP's vision tower for the benchmark: its seeded weights, its plain
reference, and its operation and byte counts.

The tower (``google/siglip-so400m-patch14-384``'s ``vision_config``;
SigLIP, arXiv:2303.15343): patch 14, no class token, a position table of
one row a patch, pre-norm blocks with heads of 72 and a tanh-GELU MLP,
``post_layernorm``, then a multihead attention-pooling (MAP) head: a
learned probe is the one query of attention over the tokens, then
``y = a + MLP(LN(a))``; the pooled row, L2-normalised, is the image
embedding.

Weights: one standard-normal draw of every parameter on the device, as
:mod:`harness.weights` draws a ViT's (dense kernels LeCun-normal,
biases, probe and position table N(0, 0.02^2), LayerNorm gains
1 + N(0, 0.05^2), shifts N(0, 0.02^2)), under the port's ``state_dict``
names so an entry can load them. The head's q/k/v are separate (out, in)
kernels, the packed in-projection split.

The reference imports nothing of the program and takes nothing it made.
It computes in float32 with TF32 off (``tf32=True``: the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import cost, reference, seeds


def tokens(cfg: dict) -> int:
    """T: the patches of the image, and no class token."""
    h, w = cost.image_hw(cfg)
    p = cfg["patch_size"]
    return (h // p) * (w // p)


def shapes(cfg: dict) -> list:
    """(name, shape, kind) of every parameter (kinds as
    ``harness.weights.vit_shapes``)."""
    d = cfg["hidden_size"]
    m = cfg["intermediate_size"]
    k = cfg["patch_size"] ** 2 * cfg["num_channels"]

    def dense(name, n_out, n_in):
        return [(name + ".weight", (n_out, n_in), ("dense", n_in)),
                (name + ".bias", (n_out,), "small")]

    def ln(name):
        return [(name + ".weight", (d,), "gain"), (name + ".bias", (d,),
                                                   "small")]

    out = [("patch_embed.weight", (k, d), ("dense", k)),
           ("patch_embed.bias", (d,), "small"),
           ("pos_embedding", (1, tokens(cfg), d), "small")]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        out += ln(b + "ln1")
        for name in ("query", "key", "value", "out"):
            out += dense(b + f"attn.{name}", d, d)
        out += ln(b + "ln2") + dense(b + "mlp.fc1", m, d) \
            + dense(b + "mlp.fc2", d, m)
    out += ln("encoder_norm")
    out += [("head.probe", (1, 1, d), "small")]
    for name in ("query", "key", "value", "out"):
        out += dense(f"head.{name}", d, d)
    out += ln("head.norm") + dense("head.mlp.fc1", m, d) \
        + dense("head.mlp.fc2", d, m)
    return out


@torch.no_grad()
def weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter of ``cfg``'s tower, f32 on ``device``, from
    ``seed``."""
    spec = shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    flat = torch.randn(total, generator=seeds.generator(seed, "weights",
                                                        device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "gain":
            out[name] = 1.0 + 0.05 * x
        elif kind == "small":
            out[name] = 0.02 * x
        else:
            out[name] = x * (1.0 / math.sqrt(kind[1]))
    return out


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _attend(q, k, v, heads: int) -> torch.Tensor:
    """(B, Tq, D), (B, T, D) x 2 -> (B, Tq, D): softmax(q k^T / sqrt(dh))
    v over ``heads`` heads of dh = D / heads."""
    def split(x):
        b, t, d = x.shape
        return x.reshape(b, t, heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    o = torch.softmax(s, dim=-1) @ v
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1)


def siglip_embed(w: dict, cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, D) f32 embeddings: normalise,
    patchify (VALID), project, add the position table, the pre-norm
    blocks (q/k/v, softmax attention, out; tanh-GELU MLP), the final
    LayerNorm, the MAP head, L2-normalised."""
    pre = cfg["preprocess"]
    p = cfg["patch_size"]
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    b, h, wd, c = images_u8.shape
    gh, gw = h // p, wd // p
    x = images_u8.to(torch.float32) * pre["rescale"]
    x = (x - torch.tensor(pre["mean"], device=x.device)) / torch.tensor(
        pre["std"], device=x.device)
    x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
    x = x @ w["patch_embed.weight"] + w["patch_embed.bias"]
    x = x + w["pos_embedding"]
    ln, dense = reference._layer_norm, reference._dense
    for i in range(cfg["num_hidden_layers"]):
        def g(name):
            return w[f"blocks.{i}.{name}"]

        y = ln(x, g("ln1.weight"), g("ln1.bias"), eps)
        q, k, v = (dense(y, g(f"attn.{n}.weight"), g(f"attn.{n}.bias"))
                   for n in ("query", "key", "value"))
        x = x + dense(_attend(q, k, v, heads), g("attn.out.weight"),
                      g("attn.out.bias"))
        y = ln(x, g("ln2.weight"), g("ln2.bias"), eps)
        y = _gelu_tanh(dense(y, g("mlp.fc1.weight"), g("mlp.fc1.bias")))
        x = x + dense(y, g("mlp.fc2.weight"), g("mlp.fc2.bias"))
    x = ln(x, w["encoder_norm.weight"], w["encoder_norm.bias"], eps)

    def hd(name, z):
        return dense(z, w[f"head.{name}.weight"], w[f"head.{name}.bias"])

    probe = w["head.probe"].expand(b, -1, -1)
    a = hd("out", _attend(hd("query", probe), hd("key", x), hd("value", x),
                          heads))
    y = _gelu_tanh(hd("mlp.fc1", ln(a, w["head.norm.weight"],
                                    w["head.norm.bias"], eps)))
    pooled = (a + hd("mlp.fc2", y))[:, 0]
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def embed_frames(w: dict, cfg: dict, frames: np.ndarray, device, *,
                 tf32: bool = False, block: int = 64) -> np.ndarray:
    """:func:`siglip_embed` over host frames in blocks of ``block``."""
    out = []
    with reference.matmul_precision(tf32):
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device)
            out.append(siglip_embed(w, cfg, x).cpu().numpy())
    return np.concatenate(out)


# ---- operations and bytes


def _products(cfg: dict, batch: int) -> list:
    """(m, k, n) of every dense product of one batch: each layer's q, k,
    v, out (B T rows, D x D), fc1 (D -> MLP), fc2 (MLP -> D); the head's
    query (the probe's one row), key and value (B T rows), out and its
    MLP (B rows)."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    rows = batch * tokens(cfg)
    layer = [(rows, d, d)] * 4 + [(rows, d, m), (rows, m, d)]
    head = [(1, d, d), (rows, d, d), (rows, d, d), (batch, d, d),
            (batch, d, m), (batch, m, d)]
    return layer * cfg["num_hidden_layers"] + head


def flops_per_frame(cfg: dict) -> float:
    """Analytic forward FLOPs (2 x MACs) of one frame: the patch
    projection, each layer's q/k/v/out, attention score and mix products
    (4 T^2 D) and MLP, and the head (its query counted a frame, as the
    published forward computes it; its one-query attention 4 T D).
    LayerNorm, GELU, softmax and adds are left out. so400m/14 at 384:
    670 GFLOP."""
    t, d = tokens(cfg), cfg["hidden_size"]
    m = cfg["intermediate_size"]
    k = cfg["patch_size"] ** 2 * cfg["num_channels"]
    per_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * m
    head = 2 * d * d + 2 * t * d * d + 2 * t * d + 2 * d * m
    return 2.0 * (t * d * k + cfg["num_hidden_layers"] * per_layer + head)


def linear_bound_s(cfg: dict, batch: int) -> float:
    """Every dense product of one batch, the head's included, each at its
    own bound (:func:`harness.cost.gemm_bound_s`)."""
    return sum(cost.gemm_bound_s(m, k, n, cfg["dtype"])
               for m, k, n in _products(cfg, batch))


def attention_bound_s(cfg: dict, batch: int) -> float:
    """Every layer's self-attention for one batch at the heads' true
    width (72: the zero-padding to the kernel's 96 is the program's, not
    the work's)."""
    heads = cfg["num_attention_heads"]
    return cfg["num_hidden_layers"] * cost.attention_bound_s(
        batch, heads, tokens(cfg), cfg["hidden_size"] // heads, cfg["dtype"])
