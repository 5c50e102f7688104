"""Stage 1: supervised ChunkEncoder training from the memmap frame store.

Port of vit_research_tpu/train/train_chunk_encoder.py with the same loop:
batches gather (B, T, D) frame embeddings straight from the store in the
JAX package's seeded order; the train step smooths the labels
(``labels * 0.9 + 0.05``), scales the BCE by 0.5, clips each gradient
tensor to norm 1.0 and takes an AdamW step (keras epsilon, decoupled
weight decay); per-epoch validation reports the unscaled, unsmoothed loss,
accuracy, confusion counts and the conditioned separation gap; the best
epoch by ``val_acc`` is kept, and every epoch is checkpointed (model,
optimizer, step) when a manager is given.

Dropout masks come from a ``torch.Generator`` on the training device,
seeded from ``(seed, epoch)`` at the start of each epoch (the JAX loop
folds the epoch into its base key), so a resumed run replays the masks of
the uninterrupted run. On a CUDA device the encoder's attention runs
kernel B (ops/attention.py) in every validation batch and in dropout-0
training steps, where its gradient is the plain version's VJP; with
attention dropout on, the training forward takes the plain path.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.db.frame_store import gather_chunk_embedding_batch
from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.heads import ChunkEncoder
from vit_research_tpu_torch.models.vit import set_dropout_generator
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train.common import (MetricAverager, TrainState,
                                                 batch_iterator,
                                                 dropout_generator,
                                                 maybe_resume)
from vit_research_tpu_torch.train.diagnostics import (conditioned_separation,
                                                      confusion_counts)
from vit_research_tpu_torch.train.optim import Optimizer
from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig


def stage1_optimizer(params, lr: float, grad_clip: float = 1.0,
                     weight_decay: float = 0.0,
                     adam_eps: float = 1e-7) -> Optimizer:
    """Per-tensor gradient clip -> Adam with decoupled weight decay (the
    reference's ``tf.clip_by_norm`` per gradient + keras ``Adam(lr,
    weight_decay)``, epsilon 1e-7)."""
    return Optimizer(params, lr=lr,
                     clip=("each", grad_clip) if grad_clip else None,
                     weight_decay=weight_decay, eps=adam_eps)


def _batch(store, chunk_index, ids, device):
    frame_embs = torch.from_numpy(
        gather_chunk_embedding_batch(store, chunk_index, ids)).to(device)
    labels = torch.from_numpy(
        chunk_index["label"][ids].astype(np.float32)).to(device)
    return frame_embs, labels


def train_chunk_encoder(store, chunk_index, train_ids, val_ids, *,
                        config: ChunkEncoderConfig | None = None,
                        num_epochs: int = 10, batch_size: int = 32,
                        lr: float = 5e-5, grad_clip: float = 1.0,
                        weight_decay: float = 5e-4, seed: int = 42,
                        ckpt_manager=None, resume: bool = False,
                        verbose: bool = False, device="cuda",
                        model: ChunkEncoder | None = None):
    """Train a ChunkEncoder on ``device``. Returns (model, best_params,
    history): the trained model, the ``state_dict`` (CPU copies) of the
    epoch with the best ``val_acc`` and one metrics dict per epoch run.

    ``model`` starts the run from given weights (default: a fresh
    encoder of ``config`` seeded from ``seed``); it is moved to
    ``device`` and trained in place. ``resume=True`` continues from the
    manager's latest checkpoint (weights, optimizer, step) and carries its
    best epoch."""
    dev = resolve_device(device)
    config = config or ChunkEncoderConfig()
    if model is None:
        model = ChunkEncoder(
            config, generator=torch.Generator().manual_seed(seed))
    model = model.to(dev)
    params = list(model.parameters())
    state = TrainState(model, stage1_optimizer(params, lr, grad_clip,
                                               weight_decay))
    state, start_epoch = maybe_resume(ckpt_manager, state, resume)

    def snapshot():
        return {k: v.detach().to("cpu", copy=True)
                for k, v in model.state_dict().items()}

    labels_all = chunk_index["label"]
    best_acc, best_params = -1.0, snapshot()
    if resume and ckpt_manager is not None and start_epoch > 0:
        # carry best-tracking across the restart: the resumed run returns
        # an earlier epoch's weights when that epoch's val_acc was best
        best_step, best_metric = ckpt_manager.best
        if best_step is not None:
            best_acc = best_metric
            best_params = ckpt_manager.restore(best_step)["params"]
    history = []
    for epoch in range(start_epoch, num_epochs):
        model.train()
        set_dropout_generator(model, dropout_generator(seed, epoch, dev))
        m = MetricAverager()
        for batch_ids in batch_iterator(list(train_ids), batch_size,
                                        seed=seed + epoch):
            ids = np.asarray(batch_ids)
            frame_embs, labels = _batch(store, chunk_index, ids, dev)
            _, logits = model(frame_embs)
            # smoothing 0 -> 0.05, 1 -> 0.95 and the 0.5x scale, train only
            smooth = labels * 0.9 + 0.05
            loss = 0.5 * losses.bce_with_logits(smooth, logits)
            grads = torch.autograd.grad(loss, params)
            state.optimizer.step(grads)
            state.step += 1
            acc = losses.compute_accuracy(labels, logits.detach())
            m.update(train_loss=loss.detach(), train_acc=acc)
        set_dropout_generator(model, None)

        model.eval()
        conf = {"tp": 0, "tn": 0, "fp": 0, "fn": 0}
        val_embs, val_labels, val_meta = [], [], []
        with torch.no_grad():
            for batch_ids in batch_iterator(list(val_ids), batch_size,
                                            shuffle=False,
                                            drop_remainder=False):
                ids = np.asarray(batch_ids)
                frame_embs, labels = _batch(store, chunk_index, ids, dev)
                emb, logits = model(frame_embs)
                # unscaled and unsmoothed
                loss = losses.bce_with_logits(labels, logits)
                acc = losses.compute_accuracy(labels, logits)
                m.update(val_loss=loss, val_acc=acc)
                for k, v in confusion_counts(labels, logits).items():
                    conf[k] += int(v)
                val_embs.append(emb.cpu().numpy())
                val_labels.append(labels.cpu().numpy())
                val_meta.append(ids)

        metrics = m.result()
        metrics.update({f"val_{k}": v for k, v in conf.items()})
        if val_embs:
            ids = np.concatenate(val_meta)
            sep = conditioned_separation(
                np.concatenate(val_embs), np.concatenate(val_labels),
                chunk_index["side"][ids], chunk_index["t_center"][ids],
                chunk_index["vid"][ids])
            metrics["separation_gap"] = sep["gap"]
        history.append(metrics)
        if verbose:
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()
                if isinstance(v, float)))

        val_acc = metrics.get("val_acc", 0.0)
        if val_acc > best_acc:
            best_acc, best_params = val_acc, snapshot()
        if ckpt_manager is not None:
            ckpt_manager.save(epoch, state.checkpoint(),
                              metrics={k: v for k, v in metrics.items()
                                       if isinstance(v, (int, float))})
            ckpt_manager.maybe_update_best(epoch, val_acc)
    return model, best_params, history


def make_encode_fn(model: ChunkEncoder, params: dict | None = None):
    """Frozen-encoder callable for the DB writers and the retrieval caches:
    (B, T, D) numpy -> (chunk_embs (B, D), class_logits (B, 1)) numpy, on
    the model's device in eval mode. ``params``: a ``state_dict`` to load
    first."""
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    dev = next(model.parameters()).device

    @torch.no_grad()
    def encode(frame_embs):
        x = torch.as_tensor(np.asarray(frame_embs, np.float32)).to(dev)
        emb, logit = model(x)
        # a bf16 encoder's logits read back as f32 (numpy has no bf16)
        return emb.cpu().numpy(), logit.float().cpu().numpy()

    return encode
