"""Exact masked top-k similarity search on torch tensors.

Port of vit_research_tpu/ops/topk.py: a matmul per block of queries, a
boolean mask folded into the score matrix, and a top-k. Ties keep
``lax.top_k``'s order (lower index first): the top-k is a stable
descending sort and a slice, since ``torch.topk`` promises no order among
equal scores. The sort holds a block's scores, sorted scores and int64
indices at once (16 bytes per score), so queries go through in blocks of
about ``_BLOCK_ELEMENTS`` scores: a whole game against a large corpus
would not fit on the card in one piece.

The int8 variant (:func:`quantize_int8`, :func:`masked_topk_int8`) serves
the vector store's int8 device corpora. Its s8 x s8 -> s32 product is an
XLA dot in the reference, not a Pallas kernel, so on the card it is
``torch._int_mm``.
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


def _topk_in_blocks(score_block, n_q: int, n_c: int, mask, k: int,
                    device):
    """Top-k of ``score_block(start, stop)`` -> (stop - start, n_c) f32
    scores, taken over blocks of queries: the mask folded in as
    ``NEG_INF``, then a stable descending sort and a slice."""
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).expand(n_q, n_c)
    kk = min(k, n_c)
    rows = max(1, _BLOCK_ELEMENTS // max(1, n_c))
    scores, idx = [], []
    for start in range(0, max(n_q, 1), rows):
        s = score_block(start, start + rows)
        if mask is not None:
            s = torch.where(mask[start:start + rows], s,
                            torch.full_like(s, NEG_INF))
        s, i = torch.sort(s, dim=-1, descending=True, stable=True)
        scores.append(s[:, :kk])
        idx.append(i[:, :kk])
    return torch.cat(scores), torch.cat(idx)


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
    return _topk_in_blocks(lambda a, b: _scores(q[a:b], c, metric),
                           q.shape[0], c.shape[0], mask, k, q.device)


def quantize_int8(x: torch.Tensor, eps: float = 1e-12):
    """Per-row symmetric int8 quantization: ``(q, scale)`` with
    ``x ~= q * scale[..., None]``, ``scale = max|row| / 127``, rounded
    half to even (``torch.round``, as ``jnp.round``). The int8 device
    corpus holds a quarter of the f32 bytes."""
    x = x.to(torch.float32)
    scale = torch.amax(torch.abs(x), dim=-1) / 127.0
    q = torch.round(x / torch.clamp_min(scale, eps)[..., None])
    return q.to(torch.int8), scale


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) int8 -> (M, N) int32 exact dot products:
    ``torch._int_mm`` (s8 x s8 -> s32). On CUDA it runs on the tensor
    cores, whose shape rules (M > 16, K and N multiples of 8) are met by
    zero padding; the CPU's takes any shape."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b.T)
    m, k = a.shape
    n = b.shape[0]
    m_pad, k_pad, n_pad = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    s = torch._int_mm(_pad_to(a, m_pad, k_pad), _pad_to(b, n_pad, k_pad).T)
    return s[:m, :n]


def masked_topk_int8(queries_q, queries_scale, corpus_q, corpus_scale,
                     mask=None, *, k: int):
    """int8 variant of :func:`masked_topk` for dot-product similarity
    (callers pre-normalise rows for cosine, as in the f32 path). Scores
    are exact s8 x s8 -> s32 dot products rescaled to f32 as
    ``s32 * (q_scale x c_scale)``; ties keep the lower index first."""
    def score_block(a, b):
        s32 = _int8_dot(queries_q[a:b], corpus_q)
        return s32.to(torch.float32) * (queries_scale[a:b, None]
                                        * corpus_scale[None, :])

    return _topk_in_blocks(score_block, queries_q.shape[0],
                           corpus_q.shape[0], mask, k, queries_q.device)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)
