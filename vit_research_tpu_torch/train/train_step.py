"""The joint train step: the full ViT and a RAGHead in one graph.

Port of vit_research_tpu/train/train_step.py (the reference's template,
nba_proj/train/train_step.py:3-21): the backbone is not frozen, and
gradients flow through every ViT layer. Frames (B, T, H, W, 3) ->
the ViT's pooled embedding a frame -> the mean over T -> L2
normalisation -> ProjectionHead -> RAGHead over the retrieved rows ->
BCE. The update is the port's train/optim.py::Optimizer.

On a CUDA device the step runs kernel B forward and backward through its
autograd Function (ops/attention.py::_Attention) in every ViT block
(T = 197, dh = 64 at ViT-B/16 @224) and in RAGHead's blocks (dh = 192);
the modules run as the JAX step applies them, without dropout (eval
mode), so the backbone's routing (models/vit.py) launches B. The patch
projection is the model's ``PatchEmbed`` matmul on normalised floats,
not kernel A (which takes uint8 frames), as in the JAX model.
"""

from __future__ import annotations

import torch

from vit_research_tpu_torch.train import losses


def make_joint_train_step(vit, proj, head, optimizer):
    """Returns step(frames (B, T, H, W, 3), retrieved (B, K, D), labels
    (B,)) -> the loss (a detached scalar tensor); the step updates
    ``optimizer.params`` (every parameter of ``vit``, ``proj`` and
    ``head`` that trains, in a fixed order) in place."""
    params = optimizer.params

    def loss_fn(frames, retrieved, labels):
        b, t = frames.shape[:2]
        emb = vit(frames.reshape(b * t, *frames.shape[2:]))["pooled"]
        emb = emb.reshape(b, t, -1).mean(dim=1)
        emb = emb / torch.clamp(torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True), min=1e-12)
        logits, _ = head(proj(emb), retrieved)
        return losses.bce_with_logits(labels, logits)

    def train_step(frames, retrieved, labels):
        for module in (vit, proj, head):
            module.eval()
        loss = loss_fn(frames, retrieved, labels)
        optimizer.step(torch.autograd.grad(loss, params))
        return loss.detach()

    return train_step
