"""Candidate reranker for retrieved chunks.

Port of vit_research_tpu/models/reranker.py: the reference imports a
``CandidateReranker`` that its repo never defined
(nba_proj/train/training_stage2.py:17, use commented out at :33-35); the
JAX package gives it a working form, ported here: score each retrieved
candidate against its query, then re-order and trim the retrieved set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_research_tpu_torch.models.vit import _lecun_normal_


class CandidateReranker(nn.Module):
    """score(q, c) = MLP([q * c, q - c]): query (B, D), candidates
    (B, K, D) -> scores (B, K). ``fc1`` and ``score`` carry the flax
    names (Dense kernels (in, out) -> ``nn.Linear`` (out, in)); the seeded
    init draws flax's lecun-normal kernels and zero biases from a
    ``torch.Generator``."""

    def __init__(self, embed_dim: int = 768, hidden_dim: int = 256, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(2 * embed_dim, hidden_dim)
        self.score = nn.Linear(hidden_dim, 1)
        with torch.no_grad():
            for lin in (self.fc1, self.score):
                _lecun_normal_(lin.weight, lin.in_features, generator)
                lin.bias.zero_()

    def forward(self, query, candidates):
        q = query[:, None, :].to(torch.float32)
        c = candidates.to(torch.float32)
        feats = torch.cat([q * c, q - c], dim=-1)
        return self.score(F.relu(self.fc1(feats)))[..., 0]

    @staticmethod
    def rerank(scores, candidates, top_k: int | None = None):
        """Candidates in descending score order, optionally the first
        ``top_k``. The sort is stable, so tied candidates keep their
        retrieved order, as ``jnp.argsort(-scores)`` keeps it."""
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
        reordered = torch.gather(
            candidates, 1, order[..., None].expand(-1, -1,
                                                   candidates.shape[-1]))
        return reordered if top_k is None else reordered[:, :top_k]
