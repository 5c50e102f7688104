"""The fast profile's ViT-B/16, written from its definitions: token
merging (ToMe, bipartite soft matching with proportional attention;
Bolya et al., 2022) and int8 products with static activation scales,
for the ``embed-fast-b16`` cell. It imports nothing of the program.

- int8 product, per dense site i with activation scale ``s_i``:
  ``q(x) = clip(round(x / s_i), -127, 127)`` (round half to even), the
  weight's rows quantised the same with ``r_n = max(max|W_n|, 1e-12) /
  127`` each; the sum of the integer products is exact (computed in
  float64, whose 53 bits hold any int32 sum of these), rounded to f32,
  times ``s_i * r_n`` (that product in f32), then the bias. The sites
  are each block's q, k, v, out, fc1, fc2, in that order. Dynamic
  products take ``s = max(max|x|, 1e-12) / 127`` of each token instead.
- Static scales (:func:`calibrate`): the forward with dynamic products
  (merging on) over the calibration frames, recording ``max|x| / 127``
  of each site's input over every token, floored at 1e-12 and
  max-reduced over the blocks of frames. The program's scales are held
  to these (:func:`scale_gap`); the reference computes on the program's
  own only once they pass that limit.
- ToMe with r a layer: after each block's attention, the tokens split
  into sources (even positions, the class token first) and destinations
  (odd); each source's best destination is the first of its largest
  cosine similarity of the head-averaged keys (norms clamped at 1e-6);
  the class token is never merged; the r sources of the largest such
  scores (ties to the earlier source) merge into their destinations by
  a size-weighted mean; kept sources keep their order, then the
  destinations. Attention adds log(size) to every key's score.
- Everything else as :mod:`harness.reference`: f32, TF32 off, exact GELU,
  the class token pooled and L2-normalised.

Merge decisions are discrete: two computations a rounding apart can
merge different tokens. The reference records each frame's smallest
merge-decision margin, over every layer: the gap between the r-th and
(r+1)-th largest source score (which sources merge) and, for each
merged source, between its best and second-best destination score
(where it goes). The cell holds frames under a margin ``delta`` to a
limit of their own: ``merge_delta`` = 2^-22, four f32 ulps of a score in
[0.5, 1), what the rounding of the 64-term dot products can move it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from harness import cost, reference


def merged_tokens(t: int, r: int, layers: int) -> list:
    """Tokens entering each of ``layers`` blocks, then after the last."""
    out = [t]
    for _ in range(layers):
        t = out[-1]
        src, dst = (t + 1) // 2, t // 2
        r_eff = max(0, min(r, src - 1))
        out.append(t - r_eff if r_eff and dst else t)
    return out


def _quantize(x, scale, qmax: int):
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def int8_dense(x, w, b, scale=None, *, act_bits: int = 8):
    """``x @ w^T + b`` through int8 with the static activation scale
    ``scale`` (an f32 0-dim tensor on x's device), or with each token's
    own (dynamic) where it is None. ``act_bits`` = 7 gives the
    activations 7 bits (±63 at twice the step): the control's coarser
    precision."""
    qmax = (1 << (act_bits - 1)) - 1
    if scale is None:
        scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True),
                                1e-12) / x.new_full((), 127.0)
    a_scale = scale if qmax == 127 else scale * (127.0 / qmax)
    rs = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / w.new_full((), 127.0)
    xq = _quantize(x, a_scale, qmax).to(torch.float64)
    wq = _quantize(w, rs[:, None], 127).to(torch.float64)
    acc = (xq.reshape(-1, x.shape[-1]) @ wq.T).to(torch.float32)
    out = acc * (a_scale.reshape(-1, 1) * rs)
    return out.reshape(*x.shape[:-1], w.shape[0]) + b


def _merge(x, metric, sizes, r: int):
    """One ToMe step: (x', sizes', the step's smallest decision margin a
    frame (B,))."""
    b, t, d = x.shape
    src_m = F.normalize(metric[:, 0::2], dim=-1, eps=1e-6)
    dst_m = F.normalize(metric[:, 1::2], dim=-1, eps=1e-6)
    s_n, d_n = src_m.shape[1], dst_m.shape[1]
    r = max(0, min(r, s_n - 1))
    inf = torch.full((b,), math.inf, device=x.device)
    if r == 0 or d_n == 0:
        return x, sizes, inf
    scores = src_m @ dst_m.transpose(1, 2)
    scores[:, 0] = -math.inf
    best, best_dst = scores.max(dim=-1)
    # first maximal destination (max's index is not promised to be the
    # first among equals)
    best_dst = (scores == best[..., None]).to(torch.int8).argmax(dim=-1)
    order = torch.sort(-best, dim=-1, stable=True).indices
    merged, kept = order[:, :r], torch.sort(order[:, r:], dim=-1).values
    ranked = torch.gather(best, 1, order)
    margin = ranked[:, r - 1] - ranked[:, r]
    if d_n > 1:
        top2 = torch.topk(scores, 2, dim=-1).values
        second = torch.gather(top2[..., 0] - top2[..., 1], 1, merged)
        margin = torch.minimum(margin, second.amin(dim=1))
    margin = torch.nan_to_num(margin, posinf=math.inf)

    xs, xd = x[:, 0::2], x[:, 1::2]
    ss, sd = sizes[:, 0::2], sizes[:, 1::2]
    to = torch.gather(best_dst, 1, merged)
    w_m = torch.gather(ss, 1, merged)
    rows = torch.gather(xs, 1, merged[..., None].expand(-1, -1, d))
    num = xd * sd[..., None]
    den = sd.clone()
    for j in range(r):  # size-weighted sums, one merged source at a time
        idx = to[:, j]
        ar = torch.arange(b, device=x.device)
        num[ar, idx] += rows[:, j] * w_m[:, j, None]
        den[ar, idx] += w_m[:, j]
    x_new = torch.cat([torch.gather(xs, 1, kept[..., None].expand(-1, -1, d)),
                       num / den[..., None]], dim=1)
    s_new = torch.cat([torch.gather(ss, 1, kept), den], dim=1)
    return x_new, s_new, margin


def fast_embed(w: dict, cfg: dict, images_u8, scales, r: int, *,
               act_bits: int = 8, record: list | None = None):
    """(B, H, W, 3) uint8 -> ((B, D) unit embeddings, (B,) smallest merge
    margin) of ViT ``cfg`` with weights ``w`` (harness/weights.py's
    names), static activation ``scales`` (6 a block; None: dynamic
    products) and ToMe's ``r``. ``record`` gathers max|x| of each site's
    input, in site order (0-dim tensors)."""
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
    sizes = torch.ones(x.shape[:2], device=x.device)
    margin = torch.full((b,), math.inf, device=x.device)
    site = None if scales is None else torch.tensor(
        list(scales), dtype=torch.float32, device=x.device)
    ln = reference._layer_norm
    for i in range(cfg["num_hidden_layers"]):
        def g(name):
            return w[f"blocks.{i}.{name}"]

        def dense(y, name, j):
            if record is not None:
                record.append(y.abs().amax())
            return int8_dense(y, g(f"{name}.weight"), g(f"{name}.bias"),
                              None if site is None else site[6 * i + j],
                              act_bits=act_bits)

        t, d = x.shape[1], x.shape[2]
        dh = d // heads
        y = ln(x, g("ln1.weight"), g("ln1.bias"), eps)
        q, k, v = (dense(y, f"attn.{n}", j).reshape(b, t, heads, dh)
                   .transpose(1, 2)
                   for j, n in enumerate(("query", "key", "value")))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dh)) \
            + torch.log(sizes)[:, None, None, :]
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
        x = x + dense(o, "attn.out", 3)
        x, sizes, m = _merge(x, k.mean(dim=1), sizes, r)
        margin = torch.minimum(margin, m)
        y = ln(x, g("ln2.weight"), g("ln2.bias"), eps)
        y = F.gelu(dense(y, "mlp.fc1", 4))
        x = x + dense(y, "mlp.fc2", 5)
    x = ln(x, w["encoder_norm.weight"], w["encoder_norm.bias"], eps)
    pooled = x[:, 0]
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-12), margin


@torch.no_grad()
def embed_frames(w: dict, cfg: dict, frames: np.ndarray, scales, r: int,
                 device, *, tf32: bool = False, act_bits: int = 8,
                 block: int = 256):
    """:func:`fast_embed` over host frames in blocks of ``block``:
    (embeddings, margins) as numpy."""
    out, margins = [], []
    with reference.matmul_precision(tf32):
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device)
            e, m = fast_embed(w, cfg, x, scales, r, act_bits=act_bits)
            out.append(e.cpu().numpy())
            margins.append(m.cpu().numpy())
    return np.concatenate(out), np.concatenate(margins)


@torch.no_grad()
def calibrate(w: dict, cfg: dict, frames: np.ndarray, r: int, device, *,
              tf32: bool = False, act_bits: int = 8,
              block: int = 256) -> tuple:
    """Static activation scales of ``frames`` by their definition: the
    forward with dynamic products in blocks of ``block``, each site's
    ``max(max|x|, 1e-12) / 127`` over every block (floats, site order)."""
    peak = None
    with reference.matmul_precision(tf32):
        for s in range(0, len(frames), block):
            x = torch.from_numpy(frames[s:s + block]).to(device)
            seen = []
            fast_embed(w, cfg, x, None, r, act_bits=act_bits, record=seen)
            m = torch.stack(seen).to(torch.float64).cpu()
            peak = m if peak is None else torch.maximum(peak, m)
    return tuple(max(float(v) / 127.0, 1e-12) for v in peak)


def scale_gap(got, want) -> float:
    """The largest relative gap of a site's scale ``got`` to ``want``'s
    (inf where the number of sites differs)."""
    if len(got) != len(want):
        return float("inf")
    gap = max(abs(g / v - 1.0) for g, v in zip(got, want))
    return gap if math.isfinite(gap) else float("inf")


# ---- operations and bytes


def flops_per_frame(cfg: dict, r: int) -> float:
    """Analytic forward operations (2 x MACs) of one frame with ToMe:
    the patch projection; each block's q/k/v/out and attention products
    at the tokens entering it, its MLP at the tokens left after its
    merge. The merge's matching product (about 2 (T/2)^2 dh), LayerNorm,
    GELU, softmax, adds and the int8 (de)quantisation are left out."""
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    ts = merged_tokens(cost.tokens(cfg), r, layers)
    k = cfg["patch_size"] ** 2 * cfg["num_channels"]
    total = (ts[0] - 1) * d * k
    for t, t_after in zip(ts[:-1], ts[1:]):
        total += 4 * t * d * d + 2 * t * t * d + 2 * t_after * d * m
    return 2.0 * total


def attention_bound_s(cfg: dict, batch: int, r: int) -> float:
    """Every block's kernel B call of one batch at the tokens entering
    it (197, 181, ..., 21 at r = 16)."""
    heads = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // heads
    ts = merged_tokens(cost.tokens(cfg), r, cfg["num_hidden_layers"])
    return sum(cost.attention_bound_s(batch, heads, t, dh, cfg["dtype"])
               for t in ts[:-1])
