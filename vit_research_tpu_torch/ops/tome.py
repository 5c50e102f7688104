"""Token merging (ToMe), opt-in and off the parity path.

Port of vit_research_tpu/ops/tome.py: bipartite soft matching from
"Token Merging: Your ViT But Faster" (Bolya et al., 2022). At every
encoder block the ``r`` most similar token pairs (cosine of the mean
attention keys) are merged by a size-weighted mean, so the sequence
shrinks by ``r`` a layer. The sizes feed back into attention as a
+log(size) key bias (proportional attention; kernel B takes it as its
``key_bias``).

Ties break as the reference breaks them: the best destination is the
first maximal index (``argmax``) and the merge order is a stable sort of
the negated best scores. The reference scatters with a one-hot matmul
(an MXU-friendly form); the port scatters with ``scatter_add_``, exact
adds in f32 whatever the matmul precision settings, in another summation
order where two sources merge into one destination.
"""

from __future__ import annotations

import torch


def merged_token_counts(tokens: int, r: int, layers: int) -> list:
    """Sequence length entering each of ``layers`` ToMe blocks, then the
    length after the last one: ``layers + 1`` counts (r is clamped per
    layer as :func:`bipartite_merge` clamps it)."""
    counts = [tokens]
    for _ in range(layers):
        t = counts[-1]
        src, dst = (t + 1) // 2, t // 2
        r_eff = max(0, min(r, src - 1))
        counts.append(t - r_eff if r_eff and dst else t)
    return counts


def match(metric: torch.Tensor, r: int):
    """The matching step of :func:`bipartite_merge`: (merged source rows
    (B, r), their destinations (B, r), kept source rows (B, S - r)
    ascending, the sources' best scores (B, S)), or None when nothing
    merges. Sources are the even tokens (CLS first, never merged),
    destinations the odd ones."""
    src_m = metric[:, 0::2].to(torch.float32)
    dst_m = metric[:, 1::2].to(torch.float32)
    s, dst_n = src_m.shape[1], dst_m.shape[1]
    r = max(0, min(r, s - 1))
    if r == 0 or dst_n == 0:
        return None

    def norm(m):
        n = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        return m / torch.clamp_min(n, 1e-6)

    scores = torch.bmm(norm(src_m), norm(dst_m).transpose(1, 2))
    scores[:, 0, :] = -torch.inf  # CLS is never a merge source
    node_max = scores.amax(dim=-1)           # (B, S)
    node_idx = scores.argmax(dim=-1)         # (B, S) first best dst
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged = order[:, :r]
    kept = torch.sort(order[:, r:], dim=-1).values  # CLS stays first
    return merged, torch.gather(node_idx, 1, merged), kept, node_max


def bipartite_merge(x: torch.Tensor, metric: torch.Tensor,
                    sizes: torch.Tensor, r: int):
    """Merge ``r`` tokens of ``x`` into their best matches.

    Args:
      x: (B, T, D) token features.
      metric: (B, T, Dm) matching features (mean attention keys).
      sizes: (B, T) f32, how many original tokens each token stands for.
      r: tokens to remove (clamped to len(src) - 1 so CLS survives).

    Returns (x', sizes') with T' = T - r_eff, ordered [kept sources (CLS
    first), destinations]. Sizes and the weighted mean are computed in
    f32 whatever the token dtype."""
    m = match(metric, r)
    if m is None:
        return x, sizes
    merged, dst_of_merged, kept, _ = m
    d = x.shape[-1]
    x_src, x_dst = x[:, 0::2], x[:, 1::2]
    s_src, s_dst = sizes[:, 0::2], sizes[:, 1::2]

    def rows(a, idx):
        return torch.gather(a, 1, idx[..., None].expand(-1, -1, d))

    x_unm = rows(x_src, kept)
    s_unm = torch.gather(s_src, 1, kept)
    s_merged = torch.gather(s_src, 1, merged)
    add_x = torch.zeros(x_dst.shape, dtype=torch.float32, device=x.device)
    add_x.scatter_add_(1, dst_of_merged[..., None].expand(-1, -1, d),
                       rows(x_src, merged).to(torch.float32)
                       * s_merged[..., None])
    add_s = torch.zeros_like(s_dst).scatter_add_(1, dst_of_merged, s_merged)
    new_s_dst = s_dst + add_s
    new_x_dst = ((x_dst.to(torch.float32) * s_dst[..., None] + add_x)
                 / new_s_dst[..., None]).to(x.dtype)
    return (torch.cat([x_unm, new_x_dst], dim=1),
            torch.cat([s_unm, new_s_dst], dim=1))
