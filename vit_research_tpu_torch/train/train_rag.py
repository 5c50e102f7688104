"""RAG-stage training: ProjectionHead + RAGHead with live frame retrieval.

Port of vit_research_tpu/train/train_rag.py, the reference's main loop
(reference: nba_proj/train/training.py:144-201,360-480) and its
no-retrieval ablation (reference: nba_proj/train/train_cls_only.py:
186-190):

- the chunk embedding is the L2-normalised mean of the frozen ViT's frame
  embeddings, from a pluggable ``chunk_embed_fn`` (the frame store:
  :func:`chunk_embed_from_store`);
- ProjectionHead -> FrameRetriever (the retrieved rows carry no gradient,
  zero-padded to top_k) -> RAGHead -> BCE + the contrastive weight times
  the simple retrieval contrastive term;
- the port's Optimizer: gradient accumulation (``accum_steps``), the
  global-norm clip and the two-phase LR, whose phase boundary also
  switches the contrastive weight;
- per-epoch validation with the cosine diagnostics (retrieval purity,
  fused-vs-projected cosine);
- ``rebuild_fn`` or a ``rebuild_scheduler`` every ``rebuild_every``
  epochs with the live projection: the DB-rebuild feedback loop.

Batches come in the JAX package's seeded numpy order; classifier dropout
masks from a generator seeded from (seed, epoch) on the training device,
so a resumed run replays the uninterrupted run's masks. On a CUDA device
RAGHead's attention runs kernel B at dh = 192 (HeadConfig(): 768 wide, 4
heads, T = 5) in every step at the config's attention dropout 0 and in
every validation batch. Retrieval runs between steps, on the retriever's
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.heads import ProjectionHead, RAGHead
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train.common import (TrainState,
                                                 chunk_metadata_batch,
                                                 maybe_resume, num_batches,
                                                 run_epochs)
from vit_research_tpu_torch.train.diagnostics import (cosine_stats,
                                                      retrieval_purity)
from vit_research_tpu_torch.train.optim import (make_optimizer,
                                                phase1_epoch_count)
from vit_research_tpu_torch.utils.configs import ExperimentConfig


def chunk_embed_from_store(store):
    """chunk_embed_fn from the memmap frame store: the mean of the chunk's
    frame embeddings, L2-normalised (host numpy, (B, D))."""
    def fn(batch_chunks):
        idx = np.asarray([[store.index_of(p) for p in ch["frames"]]
                          for ch in batch_chunks])
        emb = store.gather(idx).mean(axis=1)
        return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    return fn


def retrieval_metadata(md: dict) -> dict:
    """The retriever's columns of a chunk_metadata_batch dict."""
    return {k: md[k] for k in ("vid", "side", "t_center", "t_width")}


def make_step_fns(model: nn.ModuleDict, optimizer, use_retrieval: bool):
    """(train_step, eval_step) over ``model["proj"]`` and
    ``model["head"]``, each returning its metrics by name. Without
    retrieval (the cls_only ablation) the head
    sees the chunk embedding tiled to top_k tokens in place of the
    retrieved rows."""
    proj, head = model["proj"], model["head"]
    params = list(model.parameters())

    def tokens(chunk_embs, retrieved):
        if use_retrieval:
            return retrieved.detach()
        return chunk_embs[:, None, :].expand(-1, retrieved.shape[1], -1)

    def train_step(chunk_embs, retrieved, labels, cw: float):
        model.train()
        z = proj(chunk_embs)
        ret = tokens(chunk_embs, retrieved)
        logits, _ = head(z, ret)
        loss_cls = losses.bce_with_logits(labels, logits)
        loss_con = losses.simple_retrieval_contrastive(z, ret)
        loss = loss_cls + cw * loss_con
        optimizer.step(torch.autograd.grad(loss, params))
        return {"train_loss": loss.detach(),
                "train_acc": losses.compute_accuracy(labels,
                                                     logits.detach()),
                "loss_cls": loss_cls.detach(),
                "loss_contrastive": loss_con.detach()}

    @torch.no_grad()
    def eval_step(chunk_embs, retrieved, labels):
        model.eval()
        z = proj(chunk_embs)
        ret = tokens(chunk_embs, retrieved)
        logits, fused = head(z, ret)
        comb = cosine_stats(fused, z)
        return {"val_loss": losses.bce_with_logits(labels, logits),
                "val_acc": losses.compute_accuracy(labels, logits),
                "retr_sim": retrieval_purity(z, ret),
                "comb_sim": comb["mean"], "comb_sim_std": comb["std"]}

    return train_step, eval_step


def build_model(cfg: ExperimentConfig, seed: int) -> nn.ModuleDict:
    """``{"proj": ProjectionHead(d -> d), "head": RAGHead}``, seeded."""
    d = cfg.head.embed_dim
    gen = torch.Generator().manual_seed(seed)
    return nn.ModuleDict({
        "proj": ProjectionHead(d, proj_dim=d, generator=gen),
        "head": RAGHead(cfg.head, generator=gen)})


def train_rag(train_chunks, val_chunks, chunk_embed_fn, retriever, *,
              cfg: ExperimentConfig | None = None, use_retrieval: bool = True,
              rebuild_fn=None, rebuild_scheduler=None, ckpt_manager=None,
              resume: bool = False, seed: int = 1234, verbose: bool = False,
              init_params: dict | None = None, device="cuda"):
    """Train on ``device``. Returns (model, history): the
    ``{"proj", "head"}`` ModuleDict and one metrics dict per epoch run.

    ``retriever`` follows FrameRetriever's call contract.
    ``init_params``: a ``state_dict`` of that ModuleDict (``proj.*``,
    ``head.*``) to start from (default: fresh weights seeded from
    ``seed``). The DB-rebuild loop: ``rebuild_fn(project_fn)``
    synchronously every ``rebuild_every`` epochs (training waits), or a
    train/async_rebuild.py ``RebuildScheduler`` whose ``rebuild_fn`` takes
    ``(shadow_collection, project_fn)``, kicked with the live projection
    and swapped in at epoch boundaries. ``project_fn`` maps host (B, d)
    chunk embeddings to host projections (for the scheduler through a copy
    of the weights at the kick). Each epoch is checkpointed
    (model, optimizer, step) when a manager is given."""
    dev = resolve_device(device)
    cfg = cfg or ExperimentConfig(name="rag")
    t = cfg.train
    model = build_model(cfg, seed)
    if init_params is not None:
        model.load_state_dict(init_params)
    model = model.to(dev)
    steps_per_epoch = max(num_batches(len(train_chunks), t.batch_size), 1)
    state = TrainState(model, make_optimizer(t, steps_per_epoch,
                                             list(model.parameters())))
    state, start_epoch = maybe_resume(ckpt_manager, state, resume)
    train_step, eval_step = make_step_fns(model, state.optimizer,
                                          use_retrieval)
    proj = model["proj"]

    def batch_tensors(batch):
        md = chunk_metadata_batch(batch)
        chunk_embs = torch.as_tensor(
            np.asarray(chunk_embed_fn(batch), np.float32)).to(dev)
        labels = torch.as_tensor(md["label"].astype(np.float32)).to(dev)
        with torch.no_grad():
            z = proj(chunk_embs)
        return chunk_embs, retriever(z, retrieval_metadata(md)).to(dev), \
            labels

    # the contrastive weight switches with the LR, at the same epoch
    phase1_epochs = phase1_epoch_count(t)

    def step(epoch, *tensors):
        cw = t.contrastive_weight
        if t.contrastive_weight_phase2 is not None \
                and epoch >= phase1_epochs:
            cw = t.contrastive_weight_phase2
        return train_step(*tensors, cw)

    history = run_epochs(
        state, train_chunks, val_chunks, t, start_epoch=start_epoch,
        batch_tensors=batch_tensors, train_step=step, eval_step=eval_step,
        seed=seed, device=dev, proj=proj, ckpt_manager=ckpt_manager,
        rebuild_fn=rebuild_fn, rebuild_scheduler=rebuild_scheduler,
        verbose=verbose)
    return model, history


train_cls_only = functools.partial(train_rag, use_retrieval=False)
"""The no-retrieval ablation (reference: nba_proj/train/train_cls_only.py)."""
