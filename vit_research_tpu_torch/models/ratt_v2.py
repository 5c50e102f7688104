"""RATTHeadV2: the three-branch (support / contrast / temporal) retrieval
head of stage 2.

Port of vit_research_tpu/models/ratt_v2.py as ``nn.Module``s with the same
computation and a parameter layout that models/convert.py
(``ratt_v2_to_state_dict``) maps one to one onto the flax tree:

- per-branch two-layer projections ``BranchProjection`` (Dense(2D, relu)
  -> Dense(D));
- a one-Dense query projection with the residual local token
  ``local = q + Dense(q)``;
- learned per-branch summary tokens and type embeddings;
- the sequence ``[CLS, supSum, sup..., conSum, con..., tmpSum, tmp...,
  local]``, T = 5 + Ks + Kc + Kt (21 at k = 6/6/4, 25 at 8/8/4);
- pre-norm blocks (the backbone's ``EncoderBlock``, exact GELU, MLP 4x
  wide), each returning its attention scores;
- the classifier on CLS: Dense(2 * mlp_dim, relu) -> Dropout
  (``HeadConfig.classifier_dropout``) -> Dense(1);
- the aux outputs: the branch summaries, the local token and every
  block's scores; ``branch_attention_diagnostics`` reduces the last
  block's CLS attention per branch.

Every block returns its scores, so attention takes the plain path
(models/vit.py's ``needs_plain``), as the JAX package's XLA attention
does whenever scores are returned: this head launches no kernel.
``dtype='bfloat16'`` computes in bf16 over f32 parameters (the inputs
and the learned tokens cast to bf16, bf16 dense layers, f32 final
LayerNorm), as models/heads.py's heads do.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_research_tpu_torch.models.heads import (_init_dense_and_norms,
                                                 compute_dtype)
from vit_research_tpu_torch.models.vit import (Dropout, EncoderBlock, _dense,
                                               _norm)
from vit_research_tpu_torch.utils.configs import HeadConfig

#: the twelve learned (1, 1, D) tokens, in the flax tree's names
TOKENS = ("cls_token", "support_token", "contrast_token", "temporal_token",
          "type_cls", "type_support_summary", "type_support",
          "type_contrast_summary", "type_contrast", "type_temporal_summary",
          "type_temporal", "type_local")
#: the branch projections, in the flax tree's names
BRANCHES = ("support_proj", "contrast_proj", "temporal_proj")


class BranchProjection(nn.Module):
    """Dense(2D, relu) -> Dense(D), in the compute ``dtype`` over f32
    weights (None: the weights' dtype)."""

    def __init__(self, hidden_size: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, 2 * hidden_size)
        self.fc2 = nn.Linear(2 * hidden_size, hidden_size)
        self.dtype = dtype

    def forward(self, x):
        h = torch.relu(_dense(self.fc1, x, dtype=self.dtype))
        return _dense(self.fc2, h, dtype=self.dtype)


def token_indices(ks: int, kc: int, kt: int) -> dict:
    """Positions of the summary and local tokens in the head's sequence."""
    return {"support_summary": 1, "contrast_summary": 2 + ks,
            "temporal_summary": 3 + ks + kc, "local": 4 + ks + kc + kt}


class RATTHeadV2(nn.Module):
    """chunk (B, D), support (B, Ks, D), contrast (B, Kc, D), temporal
    (B, Kt, D) -> (class logit (B, 1), cls_out (B, D), aux)."""

    def __init__(self, config: HeadConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dt = compute_dtype(c)
        d = c.embed_dim
        self.query_proj = nn.Linear(d, d)
        self.support_proj = BranchProjection(d, dt)
        self.contrast_proj = BranchProjection(d, dt)
        self.temporal_proj = BranchProjection(d, dt)
        for name in TOKENS:
            self.register_parameter(name, nn.Parameter(torch.empty(1, 1, d)))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, c.num_heads, 4 * d, dropout_rate=c.dropout_rate,
                         attention_dropout_rate=c.dropout_rate,
                         layer_norm_eps=1e-6, dtype=dt)
            for _ in range(c.num_layers))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.classifier_fc = nn.Linear(d, 2 * c.mlp_dim)
        self.classifier_dropout = Dropout(c.classifier_dropout)
        self.classifier_logit = nn.Linear(2 * c.mlp_dim, 1)
        # the reference's initialisers: tokens normal(0.02), dense
        # kernels lecun-normal with zero bias, LayerNorm ones/zeros
        with torch.no_grad():
            for name in TOKENS:
                nn.init.normal_(getattr(self, name), std=0.02,
                                generator=generator)
        _init_dense_and_norms(self, generator)

    def forward(self, chunk_embs, support_tokens, contrast_tokens,
                temporal_tokens):
        b = chunk_embs.shape[0]
        ks, kc, kt = (support_tokens.shape[1], contrast_tokens.shape[1],
                      temporal_tokens.shape[1])
        dt = self.dtype or torch.float32
        q_raw = chunk_embs[:, None].to(dt)
        local = q_raw + _dense(self.query_proj, q_raw, dtype=self.dtype)
        sup = self.support_proj(support_tokens.to(dt))
        con = self.contrast_proj(contrast_tokens.to(dt))
        tmp = self.temporal_proj(temporal_tokens.to(dt))

        def tok(name, n=1):
            return getattr(self, name).to(dt).expand(b, n, -1)

        x = torch.cat([tok("cls_token"), tok("support_token"), sup,
                       tok("contrast_token"), con, tok("temporal_token"),
                       tmp, local], dim=1)
        x = x + torch.cat([
            tok("type_cls"), tok("type_support_summary"),
            tok("type_support", ks), tok("type_contrast_summary"),
            tok("type_contrast", kc), tok("type_temporal_summary"),
            tok("type_temporal", kt), tok("type_local")], dim=1)
        scores_all = []
        for block in self.blocks:
            x, scores = block(x, True)
            scores_all.append(scores)
        x = _norm(self.norm, x, self.dtype)
        cls_out = x[:, 0]
        h = self.classifier_dropout(torch.relu(
            _dense(self.classifier_fc, cls_out, dtype=self.dtype)))
        aux = {name: x[:, i] for name, i in
               token_indices(ks, kc, kt).items()}
        aux["local_out"] = aux.pop("local")
        aux["attn_scores"] = scores_all
        return (_dense(self.classifier_logit, h, dtype=self.dtype), cls_out,
                aux)


def branch_attention_diagnostics(scores_all, ks: int, kc: int,
                                 kt: int) -> dict:
    """The last block's head-averaged CLS attention, averaged over the
    batch, on each token group (0-d tensors)."""
    cls_attn = scores_all[-1].mean(dim=1)[:, 0, :]  # (B, T)
    at = token_indices(ks, kc, kt)
    return {
        "cls_self": cls_attn[:, 0].mean(),
        "support_summary": cls_attn[:, at["support_summary"]].mean(),
        "support_tokens": cls_attn[:, 2:2 + ks].mean(),
        "contrast_summary": cls_attn[:, at["contrast_summary"]].mean(),
        "contrast_tokens": cls_attn[:, 3 + ks:3 + ks + kc].mean(),
        "temporal_summary": cls_attn[:, at["temporal_summary"]].mean(),
        "temporal_tokens":
            cls_attn[:, 4 + ks + kc:4 + ks + kc + kt].mean(),
        "local": cls_attn[:, at["local"]].mean(),
    }
