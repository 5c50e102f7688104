"""Fused RAG-ViT: retrieval tokens joined to the ViT's token sequence.

Port of vit_research_tpu/models/rag_vit.py (the reference's fused
variant, nba_proj/rag_vit.py:259-328,474-519): :class:`RetrievalModule`
queries a collection of the port's store per sample (side and t_norm
window filters, same-clip exclusion, fixed-K zero padding), and
:class:`RAGVisionTransformer` appends the pooled retrieval tokens to
[CLS, patches] after the position embedding, so retrieval context takes
part in every attention layer. The blocks are the backbone's
``EncoderBlock``: on a CUDA device their attention launches kernel B at
T = 1 + patches + K by the backbone's routing (models/vit.py). The patch
projection is ``PatchEmbed``'s matmul on normalised float images, the
flax ``nn.Conv`` of the JAX model (its HWIO kernel is
``PatchEmbed.weight``); kernel A, which takes uint8 frames, is not on
this path, as the Pallas one is not on the JAX model's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vit_research_tpu_torch.models.heads import RetrievalMultiQueryPooler
from vit_research_tpu_torch.models.vit import (EncoderBlock, PatchEmbed,
                                               _dtype, _lecun_normal_,
                                               interpolate_pos_embedding)
from vit_research_tpu_torch.utils.configs import ViTConfig


class RetrievalModule:
    """Per-sample retrieval with side / t_norm window filters and
    same-clip exclusion (nba_proj/rag_vit.py:259-304): one store query a
    sample, on the collection's routing; (B, top_k, D) host rows, zero
    past the hits."""

    def __init__(self, collection, top_k: int = 8, time_window: float = 0.1):
        self.collection = collection
        self.top_k = top_k
        self.time_window = time_window

    def __call__(self, query_embs, sides, t_norms, clip_nums,
                 vid_nums) -> np.ndarray:
        q = np.asarray(query_embs, np.float32)
        b, d = q.shape
        out = np.zeros((b, self.top_k, d), np.float32)
        for i in range(b):
            res = self.collection.query(
                query_embeddings=q[i], n_results=self.top_k,
                where={"$and": [
                    {"side": str(sides[i])},
                    {"t_norm": {"$gte": float(t_norms[i]) - self.time_window}},
                    {"t_norm": {"$lte": float(t_norms[i]) + self.time_window}},
                    {"$or": [
                        {"clip_num": {"$ne": int(clip_nums[i])}},
                        {"vid_num": {"$ne": int(vid_nums[i])}},
                    ]},
                ]},
                include=("embeddings",))
            for j, e in enumerate(res.get("embeddings", [[]])[0][:self.top_k]):
                out[i, j] = e
        return out


class RAGVisionTransformer(nn.Module):
    """ViT whose token sequence is [CLS, patches..., retrieval tokens...]
    (nba_proj/rag_vit.py:306-328). Parameters are created in f32; for
    bf16 compute (``config.dtype``) the caller casts the module, as for
    models/vit.py::VisionTransformer. Dropout follows ``train()`` /
    ``eval()``."""

    def __init__(self, config: ViTConfig, num_retrieval_tokens: int = 4, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.num_retrieval_tokens = num_retrieval_tokens
        self.compute_dtype = _dtype(c.dtype)
        d = c.hidden_size
        self.patch_embed = PatchEmbed(c.patch_size, 3, d)
        self.retrieval_pooler = RetrievalMultiQueryPooler(
            d, num_retrieval_tokens, generator=generator)
        self.ret_type = nn.Parameter(torch.zeros(1, 1, d))
        self.cls = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embedding = nn.Parameter(torch.empty(1, c.num_patches + 1, d))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, c.num_heads, c.mlp_dim,
                         dropout_rate=c.dropout_rate,
                         attention_dropout_rate=c.attention_dropout_rate,
                         layer_norm_eps=c.layer_norm_eps,
                         gelu_approximate=c.gelu_approximate,
                         softmax_dtype=_dtype(c.softmax_dtype))
            for _ in range(c.num_layers))
        self.encoder_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
        with torch.no_grad():
            # the flax initialisers: lecun-normal kernels, zero biases,
            # trunc-normal(0.02) positions, LayerNorm ones / zeros
            nn.init.trunc_normal_(self.pos_embedding, std=0.02, a=-0.04,
                                  b=0.04, generator=generator)
            _lecun_normal_(self.patch_embed.weight,
                           self.patch_embed.weight.shape[0], generator)
            for mod in self.blocks.modules():
                if isinstance(mod, nn.Linear):
                    _lecun_normal_(mod.weight, mod.in_features, generator)
                    nn.init.zeros_(mod.bias)

    def forward(self, images: torch.Tensor, retrieved: torch.Tensor) -> dict:
        """images (B, H, W, 3) normalised floats; retrieved (B, K, D) rows
        (a :class:`RetrievalModule` answer) -> endpoints dict."""
        c = self.config
        dtype = self.compute_dtype
        p = c.patch_size
        b, h, w, _ = images.shape
        grid = (h // p, w // p)
        x = self.patch_embed(images.to(dtype))
        pooled_ret = self.retrieval_pooler(retrieved.to(dtype)) + \
            self.ret_type.to(dtype)
        pos = interpolate_pos_embedding(self.pos_embedding, c.grid, grid,
                                        has_cls=True)
        x = torch.cat([self.cls.to(dtype).expand(b, -1, -1), x], dim=1)
        x = x + pos.to(dtype)
        # retrieval tokens join after the position embedding (they carry
        # no spatial position), before the encoder
        x = torch.cat([x, pooled_ret], dim=1)
        for block in self.blocks:
            x, _ = block(x)
        x = self.encoder_norm(x)
        return {"encoded_tokens": x, "pooled": x[:, 0],
                "pre_logits": x[:, 0],
                "retrieval_tokens": x[:, -self.num_retrieval_tokens:]}


def build_rag_vit(config: ViTConfig | None = None,
                  num_retrieval_tokens: int = 4, seed: int = 0):
    """The registered 'rag_vit' backbone (nba_proj/rag_vit.py:474-519): a
    seeded model on the CPU (a ``torch.Generator``, so other numbers than
    the JAX package's ``jax.random`` draw; equal weights cross through
    models/convert.py::rag_vit_to_state_dict)."""
    return RAGVisionTransformer(
        config or ViTConfig(), num_retrieval_tokens,
        generator=torch.Generator().manual_seed(seed))
