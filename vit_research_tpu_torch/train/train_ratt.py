"""RATT training with chunk-statistic embeddings and live chunk retrieval.

Port of vit_research_tpu/train/train_ratt.py, which covers two reference
loops:

- training_ratt (reference: nba_proj/train/training_ratt.py:188-238): the
  chunk representation is the 3D-wide concat(mean, mean-delta,
  std-delta) of its frame embeddings -> 3D -> D ProjectionHead ->
  RattChunkRetriever -> RATTHead; the loss is BCE + 0.1 x in-batch
  InfoNCE (plus ``contrastive_weight`` x the max-pull retrieval
  contrastive term, 0 as the reference leaves it);
- training_chunk_works (reference:
  nba_proj/train/training_chunk_works.py:100-135), ``attention_losses``:
  the CLS -> retrieved attention importance of the last layer, an
  attention-weighted contrastive term (0.1) and an attention-entropy
  regulariser (0.01).

The loop is train_rag's (train/common.py::run_epochs): the JAX package's
batch order, the port's Optimizer (accumulation, clip, two-phase LR), per-epoch
dropout generators, checkpoints with ``proj.*`` and ``head.*`` state, and
the DB-rebuild cadence with the live projection, here
``project_fn((B, T, D) frame embeddings) -> (B, D)``. RATTHead returns
its attention scores from every layer, so its attention takes the plain
path: this loop launches no kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vit_research_tpu_torch.db.enrich import chunk_stats_torch
from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.heads import (ProjectionHead, RATTHead,
                                                 cls_retrieval_importance)
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train.common import (TrainState,
                                                 chunk_metadata_batch,
                                                 maybe_resume, num_batches,
                                                 run_epochs)
from vit_research_tpu_torch.train.optim import make_optimizer
from vit_research_tpu_torch.train.train_rag import retrieval_metadata
from vit_research_tpu_torch.utils.configs import ExperimentConfig


def make_step_fns(model: nn.ModuleDict, optimizer, *,
                  ibn_weight: float = 0.1, contrastive_weight: float = 0.0,
                  attention_weight: float = 0.0,
                  entropy_weight: float = 0.0):
    """(train_step, eval_step) over ``model["proj"]`` and
    ``model["head"]``, each returning its metrics by name (the train
    step's loss terms among them)."""
    proj, head = model["proj"], model["head"]
    params = list(model.parameters())

    def train_step(frame_embs, retrieved, labels):
        model.train()
        z = proj(chunk_stats_torch(frame_embs))
        ret = retrieved.detach()
        logit, _, _, scores = head(z, ret)
        loss_cls = losses.bce_with_logits(labels, logit)
        loss_ibn = losses.in_batch_infonce(z)
        loss = loss_cls + ibn_weight * loss_ibn
        terms = {"loss_cls": loss_cls, "loss_ibn": loss_ibn}
        if contrastive_weight:
            # the RATT stage's own variant (max pull, batch-scalar push;
            # reference: nba_proj/train/training_ratt.py:66-98)
            lc = losses.max_retrieval_contrastive(z, ret)
            loss = loss + contrastive_weight * lc
            terms["loss_contrastive"] = lc
        if attention_weight or entropy_weight:
            importance = cls_retrieval_importance(scores)
            importance = importance / (importance.sum(dim=1, keepdim=True)
                                       + 1e-8)
            if attention_weight:
                la = losses.attention_weighted_contrastive(z, ret,
                                                           importance)
                loss = loss + attention_weight * la
                terms["loss_attn_contrastive"] = la
            if entropy_weight:
                le = losses.attention_entropy(importance)
                loss = loss + entropy_weight * le
                terms["loss_attn_entropy"] = le
        optimizer.step(torch.autograd.grad(loss, params))
        return {"train_loss": loss.detach(),
                "train_acc": losses.compute_accuracy(labels, logit.detach()),
                **{k: v.detach() for k, v in terms.items()}}

    @torch.no_grad()
    def eval_step(frame_embs, retrieved, labels):
        model.eval()
        z = proj(chunk_stats_torch(frame_embs))
        logit = head(z, retrieved)[0]
        return {"val_loss": losses.bce_with_logits(labels, logit),
                "val_acc": losses.compute_accuracy(labels, logit)}

    return train_step, eval_step


def build_model(cfg: ExperimentConfig, seed: int) -> nn.ModuleDict:
    """``{"proj": ProjectionHead(3d -> d -> d), "head": RATTHead}``,
    seeded."""
    d = cfg.head.embed_dim
    gen = torch.Generator().manual_seed(seed)
    return nn.ModuleDict({
        "proj": ProjectionHead(3 * d, hidden_dim=d, proj_dim=d,
                               generator=gen),
        "head": RATTHead(cfg.head, generator=gen)})


def train_ratt(train_chunks, val_chunks, frame_embs_fn, retriever, *,
               cfg: ExperimentConfig | None = None,
               attention_losses: bool = False,
               contrastive_weight: float = 0.0,
               rebuild_fn=None, rebuild_scheduler=None,
               ckpt_manager=None, resume: bool = False,
               seed: int = 1234, verbose: bool = False, device="cuda"):
    """Train on ``device``. Returns (model, history).

    Args:
      frame_embs_fn: callable(batch_chunks) -> (B, T, D) host frame
        embeddings (a frame-store gather).
      retriever: RattChunkRetriever's call contract.
      contrastive_weight: weight of the max-pull retrieval contrastive
        term; 0.0 as the reference, which hardcodes it to zero
        (nba_proj/train/training_ratt.py:240).
      rebuild_fn / rebuild_scheduler: the chunk-DB rebuild every
        ``rebuild_every`` epochs after validation, as in train_rag, with
        the live ``project_fn((B, T, D)) -> (B, D)`` (host arrays).
    The weights start from :func:`build_model` seeded from ``seed``.
    """
    dev = resolve_device(device)
    cfg = cfg or ExperimentConfig(name="ratt")
    t = cfg.train
    model = build_model(cfg, seed).to(dev)
    steps = max(num_batches(len(train_chunks), t.batch_size), 1)
    state = TrainState(model, make_optimizer(t, steps,
                                             list(model.parameters())))
    state, start_epoch = maybe_resume(ckpt_manager, state, resume)
    train_step, eval_step = make_step_fns(
        model, state.optimizer, contrastive_weight=contrastive_weight,
        attention_weight=0.1 if attention_losses else 0.0,
        entropy_weight=0.01 if attention_losses else 0.0)
    proj = model["proj"]

    def batch_tensors(batch):
        md = chunk_metadata_batch(batch)
        frame_embs = torch.as_tensor(
            np.asarray(frame_embs_fn(batch), np.float32)).to(dev)
        labels = torch.as_tensor(md["label"].astype(np.float32)).to(dev)
        with torch.no_grad():
            z = proj(chunk_stats_torch(frame_embs))
        return frame_embs, retriever(z, retrieval_metadata(md)).to(dev), \
            labels

    history = run_epochs(
        state, train_chunks, val_chunks, t, start_epoch=start_epoch,
        batch_tensors=batch_tensors,
        train_step=lambda _epoch, *tensors: train_step(*tensors),
        eval_step=eval_step, seed=seed, device=dev, proj=proj,
        prepare=chunk_stats_torch, ckpt_manager=ckpt_manager,
        rebuild_fn=rebuild_fn, rebuild_scheduler=rebuild_scheduler,
        verbose=verbose)
    return model, history
