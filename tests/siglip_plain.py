"""SigLIP's vision tower written plainly: the published forward in plain
``torch``, float32 with TF32 off, with no kernels, no batching and
nothing of the port, for the tests to hold the port against.

The source is ``transformers``' ``modeling_siglip.py`` (SiglipVisionModel,
as ``google/siglip-so400m-patch14-384`` runs it; SigLIP, arXiv:2303.15343,
the so400m shape from arXiv:2305.13035). Parameters are read by the
tower's own state-dict names (``embeddings.patch_embedding.weight``,
``encoder.layers.{i}.self_attn.q_proj.weight``, ``head.attention.
in_proj_weight``, ...), so the port's key mapping is under test too.

1. normalise: ``x * rescale``, then ``(x - mean) / std`` a channel;
2. patches: the stride == kernel == P convolution (VALID), then the
   position table's N rows added (no class token);
3. each layer pre-norm: ``x + out(attn(LN1(x)))``, then
   ``x + fc2(gelu_tanh(fc1(LN2(x))))``; attention softmax(q k^T / sqrt(dh))
   v over H heads of dh = D / H;
4. ``post_layernorm``;
5. the attention-pooling head: a learned probe is the one query of
   multihead attention (the packed in-projection's q, k, v rows in that
   order, then ``out_proj``); ``y = a + MLP(LN(a))``, its one row;
6. the pooled row L2-normalised (the image embedding's).

Departures, each of the arithmetic's order only: the convolution is
written as patch rows times the flattened kernel (the same products and
sums); LayerNorm is ``(x - mean) / sqrt(var + eps)`` with the biased
variance, as ``nn.LayerNorm`` defines it; GELU is the tanh form written
out, as ``gelu_pytorch_tanh`` defines it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _dense(x, w, b):
    return x @ w.T + b


def _attend(q, k, v):
    """(B, H, Tq, dh), (B, H, T, dh) x 2 -> (B, Tq, H * dh)."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    o = torch.softmax(s, dim=-1) @ v
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1)


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def siglip_embed(w: dict, cfg: dict, images: torch.Tensor, *,
                 gelu=_gelu_tanh) -> torch.Tensor:
    """(B, H, W, 3) float pixels in [0, 255] (or uint8) -> (B, D) unit
    rows. ``cfg``: ``patch_size``, ``num_attention_heads``,
    ``num_hidden_layers``, ``layer_norm_eps``, and ``rescale``, ``mean``,
    ``std`` of the processor. ``gelu`` replaces the MLP's activation (a
    test's planted fault)."""
    p = cfg["patch_size"]
    h = cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    b, hh, ww, c = images.shape
    gh, gw = hh // p, ww // p
    x = images.to(torch.float32) * cfg["rescale"]
    x = (x - torch.tensor(cfg["mean"], device=x.device)) / torch.tensor(
        cfg["std"], device=x.device)
    x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
    # (B, N, C, P, P) rows against the conv kernel (D, C, P, P) flattened
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)
    kern = w["embeddings.patch_embedding.weight"]
    x = x @ kern.reshape(kern.shape[0], -1).T \
        + w["embeddings.patch_embedding.bias"]
    x = x + w["embeddings.position_embedding.weight"][None]
    for i in range(cfg["num_hidden_layers"]):
        def g(name):
            return w[f"encoder.layers.{i}.{name}"]

        y = _ln(x, g("layer_norm1.weight"), g("layer_norm1.bias"), eps)
        q, k, v = (_heads(_dense(y, g(f"self_attn.{n}_proj.weight"),
                                 g(f"self_attn.{n}_proj.bias")), h)
                   for n in ("q", "k", "v"))
        x = x + _dense(_attend(q, k, v), g("self_attn.out_proj.weight"),
                       g("self_attn.out_proj.bias"))
        y = _ln(x, g("layer_norm2.weight"), g("layer_norm2.bias"), eps)
        y = gelu(_dense(y, g("mlp.fc1.weight"), g("mlp.fc1.bias")))
        x = x + _dense(y, g("mlp.fc2.weight"), g("mlp.fc2.bias"))
    x = _ln(x, w["post_layernorm.weight"], w["post_layernorm.bias"], eps)

    d = x.shape[-1]
    w_in, b_in = w["head.attention.in_proj_weight"], \
        w["head.attention.in_proj_bias"]
    probe = w["head.probe"].expand(b, -1, -1)
    q = _heads(_dense(probe, w_in[:d], b_in[:d]), h)
    k = _heads(_dense(x, w_in[d:2 * d], b_in[d:2 * d]), h)
    v = _heads(_dense(x, w_in[2 * d:], b_in[2 * d:]), h)
    a = _dense(_attend(q, k, v), w["head.attention.out_proj.weight"],
               w["head.attention.out_proj.bias"])
    y = _ln(a, w["head.layernorm.weight"], w["head.layernorm.bias"], eps)
    y = gelu(_dense(y, w["head.mlp.fc1.weight"], w["head.mlp.fc1.bias"]))
    pooled = (a + _dense(y, w["head.mlp.fc2.weight"],
                         w["head.mlp.fc2.bias"]))[:, 0]
    return pooled / torch.linalg.vector_norm(pooled, dim=-1,
                                             keepdim=True).clamp_min(1e-12)


def seeded_weights(cfg: dict, seed: int) -> dict:
    """Every parameter of the tower under its state-dict name, float32
    on the CPU, from ``seed``: kernels N(0, 1/fan_in), biases, probe and
    position table N(0, 0.02^2), LayerNorm gains 1 + N(0, 0.05^2) and
    shifts N(0, 0.02^2) (no bias or gain left at 0 or 1, so a program
    that dropped one fails)."""
    d = cfg["hidden_size"]
    m = cfg["intermediate_size"]
    p = cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    rng = np.random.default_rng(seed)
    out = {}

    def dense(name, n_out, n_in):
        out[name + ".weight"] = rng.normal(0, n_in ** -0.5, (n_out, n_in))
        out[name + ".bias"] = rng.normal(0, 0.02, n_out)

    def ln(name):
        out[name + ".weight"] = 1.0 + rng.normal(0, 0.05, d)
        out[name + ".bias"] = rng.normal(0, 0.02, d)

    out["embeddings.patch_embedding.weight"] = rng.normal(
        0, (3 * p * p) ** -0.5, (d, 3, p, p))
    out["embeddings.patch_embedding.bias"] = rng.normal(0, 0.02, d)
    out["embeddings.position_embedding.weight"] = rng.normal(0, 0.02, (n, d))
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}."
        ln(pre + "layer_norm1")
        for name in ("q", "k", "v", "out"):
            dense(pre + f"self_attn.{name}_proj", d, d)
        ln(pre + "layer_norm2")
        dense(pre + "mlp.fc1", m, d)
        dense(pre + "mlp.fc2", d, m)
    ln("post_layernorm")
    out["head.probe"] = rng.normal(0, 0.02, (1, 1, d))
    out["head.attention.in_proj_weight"] = rng.normal(0, d ** -0.5,
                                                      (3 * d, d))
    out["head.attention.in_proj_bias"] = rng.normal(0, 0.02, 3 * d)
    dense("head.attention.out_proj", d, d)
    ln("head.layernorm")
    dense("head.mlp.fc1", m, d)
    dense("head.mlp.fc2", d, m)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in out.items()}
