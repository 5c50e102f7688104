"""Stage 2: RATTHeadV2 over cached sim / contrast / temporal branches.

Port of vit_research_tpu/train/train_stage2.py:

- training reads the pickled per-chunk cache (``fetch_cache_batch``);
  validation retrieves live against the current collection
  (``fetch_live_batch``, the validation pool encoded once), or reads the
  cache too when no encoder and collection are given (``--cached-val``);
- weighted BCE with ``pos_weight = sqrt(neg/pos)`` of the training
  labels;
- per-branch gradient RMS (``grad_rms_{support,contrast,temporal,
  query}``) each step, and the validation's best F1 and its threshold
  each epoch;
- the loop is the retrieval trainers' (train/common.py::run_epochs): the
  JAX package's seeded batch order, the port's Optimizer, per-epoch
  dropout generators, a checkpoint a epoch, ``resume``, and
  ``init_params`` for the stage-3 pinned continuation.

RATTHeadV2 returns its attention scores from every block, so the head's
attention takes the plain path and this loop launches no kernel; the
frozen stage-1 encoder behind ``encode_fn`` (live validation) runs
kernel B at dh = 96 on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.ratt_v2 import RATTHeadV2
from vit_research_tpu_torch.retrieval import cache_stage2 as CS
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train.common import (TrainState, maybe_resume,
                                                 num_batches, run_epochs)
from vit_research_tpu_torch.train.diagnostics import gradient_rms_by_branch
from vit_research_tpu_torch.train.optim import make_optimizer
from vit_research_tpu_torch.utils.configs import ExperimentConfig

BATCH_KEYS = ("query_emb", "sim_embs", "contrast_embs", "temporal_embs")


def make_step_fns(head: RATTHeadV2, optimizer, pos_weight: float):
    """(train_step, eval_step) over ``head``: each takes the batch's four
    inputs and its labels and returns its metrics by name; eval_step also
    returns the probabilities as ``probs``."""
    names = [n for n, _ in head.named_parameters()]
    params = list(head.parameters())

    def train_step(query, sim, contrast, temporal, labels):
        head.train()
        logit, _, _ = head(query, sim, contrast, temporal)
        loss = losses.bce_with_logits(labels, logit, pos_weight=pos_weight)
        grads = torch.autograd.grad(loss, params)
        grad_rms = gradient_rms_by_branch(dict(zip(names, grads)))
        optimizer.step(grads)
        return {"train_loss": loss.detach(),
                "train_acc": losses.compute_accuracy(labels, logit.detach()),
                # in the JAX package's (sorted) order
                **{f"grad_rms_{k}": v for k, v in sorted(grad_rms.items())}}

    @torch.no_grad()
    def eval_step(query, sim, contrast, temporal, labels):
        head.eval()
        logit = head(query, sim, contrast, temporal)[0]
        return {"val_loss": losses.bce_with_logits(labels, logit,
                                                   pos_weight=pos_weight),
                "val_acc": losses.compute_accuracy(labels, logit),
                # in the head's dtype, then f32 for the host (a bf16
                # head's probabilities are exact in f32)
                "probs": torch.sigmoid(logit.reshape(-1)).float()}

    return train_step, eval_step


def build_head(cfg: ExperimentConfig, seed: int) -> RATTHeadV2:
    return RATTHeadV2(cfg.head, generator=torch.Generator().manual_seed(seed))


def train_stage2(train_chunks, val_chunks, cache, *, encode_fn=None,
                 collection=None, cfg: ExperimentConfig | None = None,
                 ckpt_manager=None, seed: int = 12, verbose: bool = False,
                 log_probs_fn=None, init_params=None, resume: bool = False,
                 device="cuda"):
    """Train on ``device``. Returns (head, history).

    Args:
      cache: the per-chunk stage-2 cache (retrieval/cache_stage2.py).
      encode_fn / collection: live validation retrieval (``encode_fn(chunk)
        -> (D,)``, the frozen stage-1 encoder); without them validation
        reads the cache.
      log_probs_fn: optional callable(epoch, labels, probs) with the
        epoch's validation labels and probabilities.
      init_params: a RATTHeadV2 ``state_dict`` to start from (the stage-3
        pinned continuation); else fresh weights seeded from ``seed``.
      resume: continue from ``ckpt_manager``'s latest checkpoint (weights,
        optimizer, step), skipping the epochs it completed."""
    dev = resolve_device(device)
    cfg = cfg or ExperimentConfig(name="stage2")
    t, r, hc = cfg.train, cfg.retrieval, cfg.head
    head = build_head(cfg, seed)
    if init_params is not None:
        head.load_state_dict(init_params)
    head = head.to(dev)
    pos_weight = float(losses.sqrt_pos_weight(torch.as_tensor(
        [int(c["label"]) for c in train_chunks], dtype=torch.float32)))
    steps = max(num_batches(len(train_chunks), t.batch_size), 1)
    state = TrainState(head, make_optimizer(t, steps,
                                            list(head.parameters())))
    state, start_epoch = maybe_resume(ckpt_manager, state, resume)
    train_step, eval_step = make_step_fns(head, state.optimizer, pos_weight)

    def tensors(raw):
        return (*(torch.as_tensor(raw[k], dtype=torch.float32).to(dev)
                  for k in BATCH_KEYS),
                torch.as_tensor(raw["labels"], dtype=torch.float32).to(dev))

    live = encode_fn is not None and collection is not None
    # the frozen encoder's validation embeddings are the same in every
    # batch and epoch: encode the pool once
    pool_embs = ({CS.make_chunk_key(ch): np.asarray(encode_fn(ch), np.float32)
                  for ch in val_chunks} if live else None)

    def val_tensors(batch):
        if not live:
            return tensors(CS.fetch_cache_batch(cache, batch))
        return tensors(CS.fetch_live_batch(
            batch, encode_fn, collection, k_sim=hc.k_sim,
            k_contrast=hc.k_contrast, k_temporal=hc.k_temporal,
            future_step=r.future_chunk_step,
            search_k_content=r.search_k_content,
            search_k_temporal=r.search_k_temporal, all_chunks=val_chunks,
            pool_embs=pool_embs))

    seen = {"labels": [], "probs": []}

    def validate(*tensors_):
        out = eval_step(*tensors_)
        seen["labels"].append(tensors_[-1].cpu().numpy())
        seen["probs"].append(out.pop("probs").cpu().numpy())
        return out

    def epoch_metrics(epoch, metrics):
        if seen["labels"]:
            labels = np.concatenate(seen["labels"]).astype(np.int32)
            probs = np.concatenate(seen["probs"])
            metrics["val_best_f1"], metrics["val_best_threshold"] = \
                losses.find_best_f1(labels, probs)
            if log_probs_fn is not None:
                log_probs_fn(epoch, labels, probs)
        seen["labels"], seen["probs"] = [], []

    history = run_epochs(
        state, train_chunks, val_chunks, t, start_epoch=start_epoch,
        batch_tensors=lambda batch: tensors(
            CS.fetch_cache_batch(cache, batch)),
        val_batch_tensors=val_tensors,
        train_step=lambda _epoch, *x: train_step(*x), eval_step=validate,
        epoch_metrics=epoch_metrics, seed=seed, device=dev,
        ckpt_manager=ckpt_manager, verbose=verbose)
    return head, history
