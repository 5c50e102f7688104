"""RATT training against the label-conditioned retrieval cache.

Port of vit_research_tpu/train/train_chunk_cached.py (the reference's
cached loop, nba_proj/train/training_chunk_cached.py:815-1636): the
frozen stage-1 ChunkEncoder provides the chunk embeddings (the caller's
``chunk_embed_fn``; on a CUDA device kernel B at dh = 96); retrieval is a
lookup in the bin cache (retrieval/cache_bins.py) instead of a query a
step; the loss is BCE + 0.1 x the retrieval margin with hard negatives
(margin 0.2). The supcon / in-batch / entropy terms exist but weigh 0, as
the reference left them. Diagnostics track the retrieved labels'
agreement and the attention mass on same- and different-label tokens;
``refresh_fn(epoch)`` may swap in a new cache after every epoch.

The loop is train/common.py::run_epochs: the JAX package's batch order,
the port's Optimizer, per-epoch dropout generators, checkpoints and
``resume``. RATTHead returns its attention scores, so its attention
takes the plain path: the head launches no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.heads import (RATTHead,
                                                 cls_retrieval_importance)
from vit_research_tpu_torch.retrieval.cache_bins import get_retrieval_cache
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train.common import (TrainState,
                                                 chunk_metadata_batch,
                                                 maybe_resume, num_batches,
                                                 run_epochs)
from vit_research_tpu_torch.train.diagnostics import (
    attention_mass_by_label, label_agreement)
from vit_research_tpu_torch.train.optim import make_optimizer
from vit_research_tpu_torch.utils.configs import ExperimentConfig


def _importance(scores):
    """The last layer's CLS -> retrieved attention, normalised a row."""
    importance = cls_retrieval_importance(scores)
    return importance / (importance.sum(dim=1, keepdim=True) + 1e-8)


def make_step_fns(head: RATTHead, optimizer, *, margin_weight: float = 0.1,
                  margin: float = 0.2, supcon_weight: float = 0.0,
                  ibn_weight: float = 0.0, entropy_weight: float = 0.0):
    """(train_step, eval_step) over ``head``; both take (chunk_embs (B, D),
    retrieved (B, K, D), is_hard_negative (B, K), retrieved labels
    (B, K), labels (B,)) and return their metrics by name."""
    params = list(head.parameters())

    def train_step(chunk_embs, retrieved, hardneg, rlabels, labels):
        head.train()
        ret = retrieved.detach()
        y = labels.to(torch.float32)
        logit, _, _, scores = head(chunk_embs, ret)
        loss_cls = losses.bce_with_logits(y, logit)
        loss_margin, diag = losses.retrieval_margin(chunk_embs, ret, hardneg,
                                                    margin=margin)
        loss = loss_cls + margin_weight * loss_margin
        terms = {"loss_cls": loss_cls, "loss_margin": loss_margin, **diag}
        if supcon_weight:
            loss = loss + supcon_weight * losses.supervised_contrastive(
                losses.l2_normalize(chunk_embs), y)
        if ibn_weight:
            loss = loss + ibn_weight * losses.in_batch_infonce(chunk_embs)
        importance = _importance(scores)
        if entropy_weight:
            loss = loss + entropy_weight * losses.attention_entropy(
                importance)
        optimizer.step(torch.autograd.grad(loss, params))
        mass = attention_mass_by_label(importance.detach(), rlabels, labels)
        return {"train_loss": loss.detach(),
                "train_acc": losses.compute_accuracy(y, logit.detach()),
                "agreement": label_agreement(rlabels, labels),
                "attn_mass_same": mass["mass_same"],
                "attn_mass_diff": mass["mass_diff"],
                **{k: v.detach() for k, v in terms.items()}}

    @torch.no_grad()
    def eval_step(chunk_embs, retrieved, hardneg, rlabels, labels):
        head.eval()
        y = labels.to(torch.float32)
        logit = head(chunk_embs, retrieved)[0]
        return {"val_loss": losses.bce_with_logits(y, logit),
                "val_acc": losses.compute_accuracy(y, logit)}

    return train_step, eval_step


def build_model(cfg: ExperimentConfig, seed: int) -> RATTHead:
    """The RATTHead, seeded."""
    return RATTHead(cfg.head, generator=torch.Generator().manual_seed(seed))


def train_chunk_cached(train_chunks, val_chunks, chunk_embed_fn, cache, *,
                       cfg: ExperimentConfig | None = None, refresh_fn=None,
                       ckpt_manager=None, resume: bool = False,
                       seed: int = 1234, delta_t: float = 0.1,
                       verbose: bool = False, device="cuda"):
    """Train on ``device``. Returns (head, history).

    Args:
      chunk_embed_fn: callable(batch_chunks) -> (B, D) host frozen stage-1
        chunk embeddings.
      cache: (side, bin, label) -> pool dict (retrieval/cache_bins.py).
      refresh_fn: optional callable(epoch) -> a new cache (or None to keep
        it), after every epoch's validation.
    The weights start from :func:`build_model` seeded from ``seed``."""
    dev = resolve_device(device)
    cfg = cfg or ExperimentConfig(name="chunks_cached")
    t = cfg.train
    d = cfg.head.embed_dim
    top_k = cfg.retrieval.top_k
    head = build_model(cfg, seed).to(dev)
    steps = max(num_batches(len(train_chunks), t.batch_size), 1)
    state = TrainState(head, make_optimizer(t, steps,
                                            list(head.parameters())))
    state, start_epoch = maybe_resume(ckpt_manager, state, resume)
    train_step, eval_step = make_step_fns(
        head, state.optimizer, margin=t.margin,
        margin_weight=t.contrastive_weight)
    current = {"cache": cache}

    def batch_tensors(batch):
        md = chunk_metadata_batch(batch)
        retrieved, rlabels, hardneg = get_retrieval_cache(
            md, current["cache"], top_k=top_k, delta_t=delta_t, dim=d)
        chunk_embs = np.asarray(chunk_embed_fn(batch), np.float32)
        return tuple(torch.as_tensor(x).to(dev) for x in (
            chunk_embs, retrieved, hardneg, rlabels, md["label"]))

    def refresh(epoch, _metrics):
        # after the epoch's validation: the next epoch reads the new cache
        current["cache"] = refresh_fn(epoch) or current["cache"]

    history = run_epochs(
        state, train_chunks, val_chunks, t, start_epoch=start_epoch,
        batch_tensors=batch_tensors,
        train_step=lambda _epoch, *tensors: train_step(*tensors),
        eval_step=eval_step, seed=seed, device=dev,
        epoch_metrics=refresh if refresh_fn is not None else None,
        ckpt_manager=ckpt_manager, verbose=verbose)
    return head, history
