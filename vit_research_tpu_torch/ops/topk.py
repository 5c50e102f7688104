"""Exact masked top-k similarity search on torch tensors.

Port of vit_research_tpu/ops/topk.py: a matmul per block of queries, a
boolean mask folded into the score matrix, and a top-k. Ties keep
``lax.top_k``'s order (lower index first): the top-k is a stable
descending sort and a slice, since ``torch.topk`` promises no order among
equal scores. The sort holds a block's scores, sorted scores and int64
indices at once (16 bytes per score), so queries go through in blocks of
about ``_BLOCK_ELEMENTS`` scores: a whole game against a large corpus
would not fit on the card in one piece.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

#: scores per query block (1 GiB of sort state at 16 bytes per score)
_BLOCK_ELEMENTS = 1 << 26


def _scores(queries, corpus, metric: str):
    if metric in ("cosine", "ip"):
        # For 'cosine' the caller pre-normalises corpus and queries.
        return queries @ corpus.T
    if metric == "l2":
        # Negated squared L2 so that "higher is better" uniformly, in the
        # reference's order of operations.
        q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
        c2 = torch.sum(corpus * corpus, dim=-1)
        return -(q2 - 2.0 * (queries @ corpus.T) + c2[None, :])
    raise ValueError(f"unknown metric {metric!r}")


def masked_topk(queries: torch.Tensor, corpus: torch.Tensor, mask=None, *,
                k: int, metric: str = "cosine"):
    """Top-k most similar corpus rows per query, honouring a boolean mask.

    Args:
      queries: (Q, D); corpus: (N, D), on one device.
      mask: bool tensor broadcastable to (Q, N); True = candidate allowed.
      k: number of neighbours (clipped to N).
      metric: 'cosine' | 'ip' (dot) | 'l2'.
    Returns (scores, indices), (Q, k) each: similarities (or negated
    squared L2), masked-out entries at ``NEG_INF``; equal scores in
    ascending index order.
    """
    q, c = queries.to(torch.float32), corpus.to(torch.float32)
    n_q, n_c = q.shape[0], c.shape[0]
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device).expand(n_q, n_c)
    kk = min(k, n_c)
    rows = max(1, _BLOCK_ELEMENTS // max(1, n_c))
    scores, idx = [], []
    for start in range(0, max(n_q, 1), rows):
        s = _scores(q[start:start + rows], c, metric)
        if mask is not None:
            s = torch.where(mask[start:start + rows], s,
                            torch.full_like(s, NEG_INF))
        s, i = torch.sort(s, dim=-1, descending=True, stable=True)
        scores.append(s[:, :kk])
        idx.append(i[:, :kk])
    return torch.cat(scores), torch.cat(idx)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)
