"""Retrieval-augmented head family, first part: the pooler, the
projection head, the classifier MLP and the stage-1 ChunkEncoder.

Port of vit_research_tpu/models/heads.py as ``nn.Module``s with the same
computation and a parameter layout that models/convert.py maps one to one
onto the flax trees:

- ``RetrievalMultiQueryPooler``: M learned queries cross-attend (q k^T
  softmax, deliberately unscaled) over the retrieved set;
- ``ProjectionHead``: Dense(in, relu) -> Dense(hidden, relu) -> Dense(out)
  -> L2 normalise;
- ``ClassifierMLP``: Dense(hidden, relu) -> Dropout -> Dense(1);
- ``ChunkEncoder``: learned CLS + position table over a chunk's T frame
  embeddings -> pre-norm transformer (the backbone's ``EncoderBlock``,
  tanh GELU) -> LayerNorm -> chunk embedding (the CLS row) and a binary
  class logit.

Attention runs through models/vit.py's ``MultiHeadSelfAttention``: kernel
B on a CUDA device (dh = 96 at the real width, 768 / 8 heads) in eval mode
and in dropout-0 training, the plain path where scores are returned or
attention dropout is on. Dropout masks come from the generator that
models/vit.py::set_dropout_generator sets. ``RAGHead``, ``RATTHead`` and
``cls_retrieval_importance`` come with the retrieval trainers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vit_research_tpu_torch.models.vit import (Dropout, EncoderBlock,
                                               _lecun_normal_)
from vit_research_tpu_torch.ops.topk import l2_normalize
from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig


def _dense(in_features: int, out_features: int, generator) -> nn.Linear:
    """nn.Linear with flax Dense's init: lecun-normal weight, zero bias."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        _lecun_normal_(lin.weight, in_features, generator)
        nn.init.zeros_(lin.bias)
    return lin


class RetrievalMultiQueryPooler(nn.Module):
    def __init__(self, hidden_size: int, num_queries: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.retrieval_queries = nn.Parameter(
            torch.empty(num_queries, hidden_size))
        bound = math.sqrt(6.0 / (num_queries + hidden_size))  # xavier
        with torch.no_grad():
            self.retrieval_queries.uniform_(-bound, bound,
                                            generator=generator)

    def forward(self, retrieved):
        """(B, R, D) -> (B, M, D) pooled retrieval tokens; the scores are
        unscaled q k^T."""
        q = self.retrieval_queries.to(retrieved.dtype)
        scores = torch.einsum("md,brd->bmr", q, retrieved)
        weights = torch.softmax(scores, dim=-1)
        return torch.einsum("bmr,brd->bmd", weights, retrieved)


class ProjectionHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 768,
                 proj_dim: int = 768, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d1 = _dense(input_dim, input_dim, generator)
        self.d2 = _dense(input_dim, hidden_dim, generator)
        self.out = _dense(hidden_dim, proj_dim, generator)

    def forward(self, x):
        x = torch.relu(self.d1(x))
        x = torch.relu(self.d2(x))
        return l2_normalize(self.out(x))


class ClassifierMLP(nn.Module):
    """Dense(hidden, relu) -> Dropout -> Dense(1)."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 dropout_rate: float = 0.2, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc = _dense(in_features, hidden_dim, generator)
        self.dropout = Dropout(dropout_rate)
        self.logit = _dense(hidden_dim, 1, generator)

    def forward(self, x):
        return self.logit(self.dropout(torch.relu(self.fc(x))))


class ChunkEncoder(nn.Module):
    """(B, T, D) frame embeddings -> (chunk embedding (B, D), class logit
    (B, 1)[, per-layer attention probabilities]).

    The class head's dropout is the reference's fixed 0.2. Only
    ``dtype='float32'`` is ported."""

    def __init__(self, config: ChunkEncoderConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        if c.dtype != "float32":
            raise NotImplementedError(
                f"ChunkEncoderConfig.dtype={c.dtype!r} is not ported; the "
                "port's chunk encoder computes in float32")
        self.config = c
        d = c.embed_dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, 1 + c.max_len, d))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, c.num_heads, c.mlp_dim,
                         dropout_rate=c.dropout_rate,
                         attention_dropout_rate=c.dropout_rate,
                         layer_norm_eps=1e-6, gelu_approximate=True)
            for _ in range(c.num_layers))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.class_head = ClassifierMLP(d, generator=generator)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init with the reference's initialisers: CLS and position
        table normal(0.02), dense kernels lecun-normal with zero bias,
        LayerNorm ones/zeros. Equal weights across the two packages come
        from models/convert.py, not from a shared seed."""
        nn.init.normal_(self.cls_token, std=0.02, generator=generator)
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, frame_embeddings: torch.Tensor, *,
                return_attention: bool = False):
        c = self.config
        b, t, d = frame_embeddings.shape
        if d != c.embed_dim:
            raise ValueError(f"expected dim {c.embed_dim}, got {d}")
        if t > c.max_len:
            raise ValueError(
                f"chunk has {t} frames but ChunkEncoderConfig.max_len is "
                f"{c.max_len}; raise max_len (the pos table is sized to it)")
        x = frame_embeddings.to(torch.float32)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embedding[:, : t + 1]
        scores_all = []
        for block in self.blocks:
            x, scores = block(x, return_attention)
            if scores is not None:
                scores_all.append(scores)
        x = self.norm(x)
        chunk_emb = x[:, 0]
        class_logit = self.class_head(chunk_emb)
        if return_attention:
            return chunk_emb, class_logit, scores_all
        return chunk_emb, class_logit
