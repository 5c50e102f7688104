"""The loss zoo used across the training stages.

Port of vit_research_tpu/train/losses.py as tensor functions with the
same semantics:

- BCE / weighted BCE with ``pos_weight = sqrt(neg/pos)``;
- simple retrieval contrastive: pull toward the own retrieved mean, push
  from the batch-rolled neighbour, and its max-over-K variant;
- attention-weighted retrieval contrastive and attention entropy;
- in-batch InfoNCE over the chunk-embedding similarity matrix;
- supervised contrastive;
- retrieval margin with hard negatives and validity masking;
- the F1 threshold sweep (host numpy, for evaluation).

Each takes and returns tensors on the inputs' device; none has a
data-dependent shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l2_normalize(x, dim: int = -1, eps: float = 1e-8):
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def bce_with_logits(labels, logits, *, pos_weight=None,
                    label_smoothing: float = 0.0):
    """Mean binary cross-entropy on logits. ``pos_weight`` scales the
    positive term (pass :func:`sqrt_pos_weight` for the stage-2 rule)."""
    labels = labels.reshape(-1).to(torch.float32)
    logits = logits.reshape(-1).to(torch.float32)
    if label_smoothing:
        labels = labels * (1.0 - label_smoothing) + 0.5 * label_smoothing
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    pw = 1.0 if pos_weight is None else pos_weight
    per = -(pw * labels * log_p + (1.0 - labels) * log_not_p)
    return per.mean()


def sqrt_pos_weight(labels):
    """sqrt(neg/pos) of a label batch or dataset (each count at least 1)."""
    labels = labels.reshape(-1).to(torch.float32)
    pos = torch.clamp(labels.sum(), min=1.0)
    neg = torch.clamp((1.0 - labels).sum(), min=1.0)
    return torch.sqrt(neg / pos)


def compute_accuracy(labels, logits):
    labels = labels.reshape(-1).to(torch.int32)
    preds = (torch.sigmoid(logits.reshape(-1)) > 0.5).to(torch.int32)
    return (preds == labels).to(torch.float32).mean()


def simple_retrieval_contrastive(q, retrieved):
    """pull = 1 - cos(q, mean(retrieved)); push = cos(q, rolled neighbour)."""
    r_mean = retrieved.mean(dim=1)
    pos_sim = (q * r_mean).sum(-1)
    neg_sim = (q * torch.roll(r_mean, shifts=1, dims=0)).sum(-1)
    return ((1.0 - pos_sim) + neg_sim).mean()


def max_retrieval_contrastive(q, retrieved):
    """The pull is against the best-matching retrieved token (max cosine
    over K), the push a batch scalar: the mean cosine against the rolled
    neighbourhood mean, added to every sample's pull."""
    pos_sim = (q[:, None, :] * retrieved).sum(-1).max(dim=1).values
    r_mean = retrieved.mean(dim=1)
    push = (q * torch.roll(r_mean, shifts=1, dims=0)).sum(-1).mean()
    return ((1.0 - pos_sim) + push).mean()


def attention_weighted_contrastive(q, retrieved, importance):
    """Pull/push as above against the retrieved set pooled with the CLS
    importance weights."""
    r_attn = (importance[:, :, None] * retrieved).sum(1)
    pos_sim = (q * r_attn).sum(-1)
    neg_sim = (q * torch.roll(r_attn, shifts=1, dims=0)).sum(-1)
    return ((1.0 - pos_sim) + neg_sim).mean()


def attention_entropy(importance, eps: float = 1e-8):
    return (-(importance * torch.log(importance + eps)).sum(1)).mean()


def in_batch_infonce(z):
    """Cross-entropy of each row's self-similarity against the batch
    (row i's positive is column i)."""
    z = l2_normalize(z)
    sim = z @ z.T
    labels = torch.arange(z.shape[0], device=z.device)
    return F.cross_entropy(sim, labels)


def supervised_contrastive(z, labels, temperature: float = 0.1):
    labels = labels.reshape(-1).to(torch.int32)
    b = z.shape[0]
    sim = (z @ z.T) / temperature
    self_mask = torch.eye(b, dtype=torch.bool, device=z.device)
    pos_mask = (labels[:, None] == labels[None, :]) & ~self_mask

    sim = sim - sim.max(dim=1, keepdim=True).values
    exp_sim = torch.exp(sim) * (~self_mask).to(torch.float32)
    log_prob = sim - torch.log(exp_sim.sum(1, keepdim=True) + 1e-8)

    pos_f = pos_mask.to(torch.float32)
    pos_count = pos_f.sum(1)
    mean_log_prob_pos = (pos_f * log_prob).sum(1) / (pos_count + 1e-8)
    valid = (pos_count > 0).to(torch.float32)
    return -(mean_log_prob_pos * valid).sum() / torch.clamp(valid.sum(),
                                                            min=1.0)


def retrieval_margin(anchor, retrieved, is_hard_negative, margin: float = 0.2):
    """Hinge on (mean positive cosine) - (mean hard-negative cosine).

    ``is_hard_negative``: (B, K) with 0 = positive, 1 = hard negative,
    -1 = padding. Samples lacking either side are masked out. Returns
    (loss, diagnostics)."""
    anchor = l2_normalize(anchor)
    retrieved = l2_normalize(retrieved)
    sims = (anchor[:, None, :] * retrieved).sum(-1)

    pos_mask = (is_hard_negative == 0).to(torch.float32)
    neg_mask = (is_hard_negative == 1).to(torch.float32)
    pos_count = pos_mask.sum(1)
    neg_count = neg_mask.sum(1)
    pos_score = (sims * pos_mask).sum(1) / torch.clamp(pos_count, min=1.0)
    neg_score = (sims * neg_mask).sum(1) / torch.clamp(neg_count, min=1.0)

    valid = ((pos_count > 0) & (neg_count > 0)).to(torch.float32)
    per = torch.relu(margin - pos_score + neg_score) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    loss = per.sum() / denom
    diag = {
        "ret_pos_score": (pos_score * valid).sum() / denom,
        "ret_neg_score": (neg_score * valid).sum() / denom,
        "ret_valid_frac": valid.mean(),
    }
    return loss, diag


def find_best_f1(labels, probs, thresholds=None):
    """Threshold sweep for F1 on the host: (best F1, its threshold)."""
    labels = np.reshape(np.asarray(labels), (-1,))
    probs = np.reshape(np.asarray(probs), (-1,))
    thresholds = (np.linspace(0.05, 0.95, 50) if thresholds is None
                  else np.asarray(thresholds))
    best_f1, best_t = 0.0, 0.5
    for t in thresholds:
        preds = (probs > t).astype(int)
        tp = np.sum((preds == 1) & (labels == 1))
        fp = np.sum((preds == 1) & (labels == 0))
        fn = np.sum((preds == 0) & (labels == 1))
        f1 = 2 * tp / max(2 * tp + fp + fn, 1)
        if f1 > best_f1:
            best_f1, best_t = float(f1), float(t)
    return best_f1, best_t
