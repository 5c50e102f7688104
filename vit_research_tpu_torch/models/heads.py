"""Retrieval-augmented head family: the pooler, the projection head, the
classifier MLP, the stage-1 ChunkEncoder, RAGHead and RATTHead.

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
  class logit;
- ``RAGHead``: the CLS token and M pooled retrieval tokens (plus type
  embeddings and a position table) -> pre-norm transformer ->
  LayerNorm -> Dense(256) -> Dense(1) logit and the fused CLS row;
- ``RATTHead``: like RAGHead over the raw retrieved tokens (no pooler, a
  ``max_tokens`` position table), returning (class logit, relevance
  logit or None, fused CLS row, per-layer attention probabilities);
- ``cls_retrieval_importance``: the last layer's head-averaged CLS ->
  retrieved-token attention.

Attention runs through models/vit.py's ``MultiHeadSelfAttention``: kernel
B on a CUDA device in eval mode and in dropout-0 training (dh = 96 in the
chunk encoder, 768 / 8 heads; dh = 192 in RAGHead, 768 / 4 heads, at T =
1 + num_queries = 5), the plain path where scores are returned (every
RATTHead layer) or attention dropout is on. Dropout masks come from the
generator that models/vit.py::set_dropout_generator sets.

``dtype='bfloat16'`` (``ChunkEncoderConfig`` / ``HeadConfig``) computes
in bf16 over f32 parameters, as the reference's flax modules do: the
inputs, the CLS token, the type and position embeddings and the retrieved
rows are cast to bf16, the dense layers and the pooler's einsums run in
bf16, the blocks follow models/vit.py's compute-dtype rule, and the final
LayerNorm promotes to f32 (the chunk embedding and the fused CLS row are
f32, the logits bf16). The f32 parameters are what an optimizer steps and
a checkpoint holds. In bf16, kernel B runs its ``attn_bf16``
instantiations (dh = 96 in the chunk encoder, 192 in RAGHead).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vit_research_tpu_torch.models.vit import (Dropout, EncoderBlock,
                                               _dense as _run_dense, _dtype,
                                               _lecun_normal_, _norm)
from vit_research_tpu_torch.ops.topk import l2_normalize
from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                  HeadConfig)


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
    """Dense(hidden, relu) -> Dropout -> Dense(1), in the compute
    ``dtype`` over f32 weights (None: the weights' dtype)."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 dropout_rate: float = 0.2, *,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc = _dense(in_features, hidden_dim, generator)
        self.dropout = Dropout(dropout_rate)
        self.logit = _dense(hidden_dim, 1, generator)
        self.dtype = dtype

    def forward(self, x):
        h = torch.relu(_run_dense(self.fc, x, dtype=self.dtype))
        return _run_dense(self.logit, self.dropout(h), dtype=self.dtype)


def compute_dtype(config) -> torch.dtype | None:
    """The heads' compute dtype over f32 parameters: bf16 for
    ``dtype='bfloat16'``, None (the parameters' own f32) otherwise."""
    dt = _dtype(config.dtype)
    return None if dt == torch.float32 else dt


@torch.no_grad()
def _init_dense_and_norms(module: nn.Module, generator) -> None:
    """Every ``nn.Linear`` of ``module`` lecun-normal with zero bias (flax
    Dense's init), every LayerNorm ones/zeros."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight, mod.in_features, generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def _head_blocks(c: HeadConfig) -> nn.ModuleList:
    """The heads' pre-norm blocks: the backbone's EncoderBlock, MLP 4x
    wide, tanh GELU, in the config's compute dtype."""
    return nn.ModuleList(
        EncoderBlock(c.embed_dim, c.num_heads, 4 * c.embed_dim,
                     dropout_rate=c.dropout_rate,
                     attention_dropout_rate=c.dropout_rate,
                     layer_norm_eps=1e-6, gelu_approximate=True,
                     dtype=compute_dtype(c))
        for _ in range(c.num_layers))



class ChunkEncoder(nn.Module):
    """(B, T, D) frame embeddings -> (chunk embedding (B, D), class logit
    (B, 1)[, per-layer attention probabilities]).

    The class head's dropout is the reference's fixed 0.2."""

    def __init__(self, config: ChunkEncoderConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = compute_dtype(c)
        d = c.embed_dim
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, 1 + c.max_len, d))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, c.num_heads, c.mlp_dim,
                         dropout_rate=c.dropout_rate,
                         attention_dropout_rate=c.dropout_rate,
                         layer_norm_eps=1e-6, gelu_approximate=True,
                         dtype=self.dtype)
            for _ in range(c.num_layers))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.class_head = ClassifierMLP(d, generator=generator,
                                        dtype=self.dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init with the reference's initialisers: CLS and position
        table normal(0.02), dense kernels lecun-normal with zero bias,
        LayerNorm ones/zeros. Equal weights across the two packages come
        from models/convert.py, not from a shared seed."""
        nn.init.normal_(self.cls_token, std=0.02, generator=generator)
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        _init_dense_and_norms(self, generator)

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
        dt = self.dtype or torch.float32
        x = frame_embeddings.to(dt)
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embedding[:, : t + 1].to(dt)
        scores_all = []
        for block in self.blocks:
            x, scores = block(x, return_attention)
            if scores is not None:
                scores_all.append(scores)
        x = _norm(self.norm, x, self.dtype)
        chunk_emb = x[:, 0]
        class_logit = self.class_head(chunk_emb)
        if return_attention:
            return chunk_emb, class_logit, scores_all
        return chunk_emb, class_logit


class RAGHead(nn.Module):
    """cls (B, D) + retrieved (B, R, D) -> (logits (B, 1), fused (B, D)).

    The retrieved rows are pooled into ``num_queries`` tokens, so the
    blocks see T = 1 + num_queries tokens (5 at ``HeadConfig()``)."""

    def __init__(self, config: HeadConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = compute_dtype(c)
        d = c.embed_dim
        self.pooler = RetrievalMultiQueryPooler(d, c.num_queries,
                                                generator=generator)
        self.cls_type = nn.Parameter(torch.zeros(1, 1, d))
        self.ret_type = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, 1 + c.num_queries,
                                                      d))
        self.blocks = _head_blocks(c)
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.classifier = ClassifierMLP(d, c.hidden_dim,
                                        c.classifier_dropout,
                                        dtype=self.dtype)
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, std=0.02,
                            generator=generator)
        _init_dense_and_norms(self, generator)

    def forward(self, cls_embeddings, retrieved_embeddings):
        dt = self.dtype or torch.float32
        pooled = self.pooler(retrieved_embeddings.to(dt))
        cls_tok = cls_embeddings[:, None].to(dt) + self.cls_type.to(dt)
        x = torch.cat([cls_tok, pooled + self.ret_type.to(dt)], dim=1) \
            + self.pos_embedding.to(dt)
        for block in self.blocks:
            x, _ = block(x)
        fused_cls = _norm(self.norm, x, self.dtype)[:, 0]
        return self.classifier(fused_cls), fused_cls


class RATTHead(nn.Module):
    """cls (B, D) + raw retrieved (B, K, D) -> (class_logit, relevance_logit
    or None, fused (B, D), per-layer attention probabilities (B, H, T,
    T)). Every layer returns its scores, so attention takes the plain
    path (as the reference's XLA path, which serves scores)."""

    def __init__(self, config: HeadConfig, use_relevance_head: bool = False,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = compute_dtype(c)
        d = c.embed_dim
        self.cls_type = nn.Parameter(torch.zeros(1, 1, d))
        self.ret_type = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, c.max_tokens, d))
        self.blocks = _head_blocks(c)
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.class_head = ClassifierMLP(d, c.hidden_dim, c.classifier_dropout,
                                        dtype=self.dtype)
        self.relevance_head = (ClassifierMLP(d, c.hidden_dim,
                                             c.classifier_dropout,
                                             dtype=self.dtype)
                               if use_relevance_head else None)
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, std=0.02,
                            generator=generator)
        _init_dense_and_norms(self, generator)

    def forward(self, cls_embeddings, retrieved_embeddings, *,
                use_retrieval: bool = True):
        c = self.config
        dt = self.dtype or torch.float32
        x = cls_embeddings[:, None].to(dt) + self.cls_type.to(dt)
        if use_retrieval:
            x = torch.cat([x, retrieved_embeddings.to(dt)
                           + self.ret_type.to(dt)], dim=1)
        seq = x.shape[1]
        if seq > c.max_tokens:
            raise ValueError(f"sequence {seq} exceeds max_tokens "
                             f"{c.max_tokens}")
        x = x + self.pos_embedding[:, :seq].to(dt)
        scores_all = []
        for block in self.blocks:
            x, scores = block(x, True)
            scores_all.append(scores)
        fused = _norm(self.norm, x, self.dtype)[:, 0]
        relevance = (self.relevance_head(fused)
                     if self.relevance_head is not None else None)
        return self.class_head(fused), relevance, fused, scores_all


def cls_retrieval_importance(attention_scores):
    """CLS -> retrieved-token importance (B, T - 1): the last layer's
    attention probabilities (B, H, T, T), CLS row, averaged over heads,
    without the CLS -> CLS entry."""
    return attention_scores[-1][:, :, 0, :].mean(dim=1)[:, 1:]
