"""The plain reference: the same functions as the program, written from
their definitions in plain PyTorch, in float32 with TF32 off (float64 for
the store's scores). It imports nothing of the program and takes nothing
the program made: it reads the harness's own weights, frames and rows.

``tf32=True`` computes the same in TF32, the nearest precision below the
configuration's: that is the control, which the comparison has to fail.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for every matmul and convolution of the region."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _dense(x, w, b):
    return x @ w.T + b


def vit_embed(w: dict, cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames -> (B, D) f32 embeddings: normalise,
    patchify (VALID: trailing rows and columns that fill no patch are
    cropped), project, add the class token and the position table, the
    pre-norm blocks (q/k/v, softmax attention, out; exact-GELU MLP), the
    final LayerNorm, the class token as the pooled output, L2 normalised."""
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
    x = torch.cat([w["cls"].expand(b, -1, -1), x], dim=1) + w["pos_embedding"]
    t, d = x.shape[1], x.shape[2]
    dh = d // heads
    for i in range(cfg["num_hidden_layers"]):
        pre_b = f"blocks.{i}."

        def g(name):
            return w[pre_b + name]

        y = _layer_norm(x, g("ln1.weight"), g("ln1.bias"), eps)
        q, k, v = (_dense(y, g(f"attn.{n}.weight"), g(f"attn.{n}.bias"))
                   .reshape(b, t, heads, dh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
        o = torch.softmax(s, dim=-1) @ v
        o = o.transpose(1, 2).reshape(b, t, d)
        x = x + _dense(o, g("attn.out.weight"), g("attn.out.bias"))
        y = _layer_norm(x, g("ln2.weight"), g("ln2.bias"), eps)
        y = F.gelu(_dense(y, g("mlp.fc1.weight"), g("mlp.fc1.bias")))
        x = x + _dense(y, g("mlp.fc2.weight"), g("mlp.fc2.bias"))
    x = _layer_norm(x, w["encoder_norm.weight"], w["encoder_norm.bias"], eps)
    pooled = x[:, 0]
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def embed_frames(w: dict, cfg: dict, frames: np.ndarray, device, *,
                 tf32: bool = False, block: int = 256) -> np.ndarray:
    """:func:`vit_embed` over host frames in blocks of ``block``."""
    out = []
    with matmul_precision(tf32):
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device)
            out.append(vit_embed(w, cfg, x).cpu().numpy())
    return np.concatenate(out)


class CosineScores:
    """Exact cosine scores of queries against a corpus, in float64 on
    ``device``: rows and queries L2-normalised (norms clamped at 1e-12),
    then their dot products."""

    def __init__(self, rows: np.ndarray, device):
        self.device = device
        c = torch.from_numpy(rows).to(device, torch.float64)
        self.corpus = c / torch.linalg.vector_norm(
            c, dim=1, keepdim=True).clamp_min(1e-12)

    @torch.no_grad()
    def __call__(self, queries: np.ndarray) -> torch.Tensor:
        q = torch.from_numpy(queries).to(self.device, torch.float64)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(
            1e-12)
        return q @ self.corpus.T


@torch.no_grad()
def cosine_topk(rows: np.ndarray, queries: np.ndarray, k: int, device, *,
                tf32: bool = False, block: int = 256):
    """The store's exact query computed plainly in f32 (``tf32``: in
    TF32), over blocks of ``block`` queries: (distances 1 - score,
    indices), (Q, k) each, ties in index order."""
    def unit(x):
        x = torch.from_numpy(x).to(device, torch.float32)
        return x / torch.linalg.vector_norm(x, dim=1,
                                            keepdim=True).clamp_min(1e-12)

    dist, idx = [], []
    with matmul_precision(tf32):
        c = unit(rows)
        for s in range(0, len(queries), block):
            sc = unit(queries[s:s + block]) @ c.T
            sc, i = torch.sort(sc, dim=1, descending=True, stable=True)
            dist.append((1.0 - sc[:, :k]).cpu().numpy())
            idx.append(i[:, :k].cpu().numpy())
    return np.concatenate(dist), np.concatenate(idx)
