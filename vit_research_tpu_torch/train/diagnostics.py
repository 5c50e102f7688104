"""Validation-as-testing diagnostics.

Port of vit_research_tpu/train/diagnostics.py: the per-epoch invariants
the training loops report instead of tests:

- retrieval purity and cosine statistics between aligned embeddings;
- retrieved-label agreement and attention mass on same- vs
  different-label tokens;
- conditioned embedding separation: same side, close time, different
  video (host numpy, pair enumeration);
- per-branch gradient RMS;
- confusion counts.
"""

from __future__ import annotations

import numpy as np
import torch


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def cosine_stats(a, b):
    """Mean and (population) std of the cosine between aligned rows."""
    cos = (_unit(a) * _unit(b)).sum(-1)
    return {"mean": cos.mean(), "std": cos.std(correction=0)}


def retrieval_purity(query, retrieved):
    """Mean cosine between each query and its retrieved set (nonzero rows)."""
    cos = (_unit(query)[:, None, :] * _unit(retrieved)).sum(-1)  # (B, K)
    nonzero = (torch.linalg.vector_norm(retrieved, dim=-1) > 1e-6) \
        .to(torch.float32)
    return (cos * nonzero).sum() / torch.clamp(nonzero.sum(), min=1.0)


def label_agreement(retrieved_labels, labels, pad_value: int = -1):
    """Fraction of retrieved tokens whose label matches the anchor's."""
    labels = labels.reshape(-1, 1)
    valid = (retrieved_labels != pad_value).to(torch.float32)
    agree = (retrieved_labels == labels).to(torch.float32) * valid
    return agree.sum() / torch.clamp(valid.sum(), min=1.0)


def attention_mass_by_label(importance, retrieved_labels, labels,
                            pad_value: int = -1):
    """Attention mass on same-label vs. different-label retrieved tokens."""
    labels = labels.reshape(-1, 1)
    valid = (retrieved_labels != pad_value).to(torch.float32)
    same = (retrieved_labels == labels).to(torch.float32) * valid
    diff = (retrieved_labels != labels).to(torch.float32) * valid
    return {
        "mass_same": (importance * same).sum(1).mean(),
        "mass_diff": (importance * diff).sum(1).mean(),
    }


def conditioned_separation(embs, labels, sides, t_centers, vids,
                           time_gap: float = 0.15):
    """Pos-vs-neg cosine gap among comparable pairs: same side, close
    t_center, different video. Host numpy; ``nan`` where a side has no
    pair."""
    embs = np.asarray(embs)
    embs = embs / (np.linalg.norm(embs, axis=-1, keepdims=True) + 1e-8)
    labels = np.reshape(np.asarray(labels), (-1,))
    sides = np.asarray(sides, dtype=object)
    t_centers = np.asarray(t_centers, np.float64)
    vids = np.asarray(vids)

    comparable = (
        (sides[:, None] == sides[None, :])
        & (np.abs(t_centers[:, None] - t_centers[None, :]) <= time_gap)
        & (vids[:, None] != vids[None, :])
    )
    cos = embs @ embs.T
    same = comparable & (labels[:, None] == labels[None, :])
    diff = comparable & (labels[:, None] != labels[None, :])
    pos = float(cos[same].mean()) if same.any() else float("nan")
    neg = float(cos[diff].mean()) if diff.any() else float("nan")
    return {"pos_cos": pos, "neg_cos": neg, "gap": pos - neg}


def confusion_counts(labels, logits):
    """tp, tn, fp, fn at sigmoid(logit) > 0.5, as int64 tensors."""
    labels = labels.reshape(-1).to(torch.int32)
    preds = (torch.sigmoid(logits.reshape(-1)) > 0.5).to(torch.int32)
    return {
        "tp": ((preds == 1) & (labels == 1)).sum(),
        "tn": ((preds == 0) & (labels == 0)).sum(),
        "fp": ((preds == 1) & (labels == 0)).sum(),
        "fn": ((preds == 0) & (labels == 1)).sum(),
    }


def gradient_rms_by_branch(grads: dict, branches=("support", "contrast",
                                                  "temporal", "query")):
    """Per-branch gradient RMS over a ``{name: grad}`` dict (a module's
    ``named_parameters`` order, or a flattened tree's ``a/b/c`` paths): a
    branch takes every gradient whose name contains it; 0 where none
    does."""
    out = {}
    for branch in branches:
        total, count = 0.0, 0
        for name, g in grads.items():
            if branch in name:
                total = total + torch.sum(torch.square(g))
                count += g.numel()
        out[branch] = torch.sqrt(total / count) if count \
            else torch.tensor(0.0)
    return out
