"""TemporalHead training: full-sequence Adam on the masked cross-entropy.

Port of vit_research_tpu/train/train_temporal.py (the reference's loop:
Adam lr 1e-5, 3000 epochs, one full-sequence batch,
CrossEntropy(ignore_index=-1); nba_proj/smarter_generate_clips.py:22-24,
244-266). The JAX package runs the epochs as one jitted ``lax.scan``;
here they are a loop on the device whose losses are written into a
device tensor and read back once, at the end (a ``.item()`` an epoch
would cost one synchronisation each). ``torch.optim.Adam`` takes optax
``adam``'s defaults: betas the float32 0.9 and 0.999 optax multiplies by,
eps 1e-8, no eps_root. Forward and backward run inside
models/temporal_head.py::f32_convolutions, so the card computes float32
convolutions whatever cuDNN's global TF32 flag says.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models.temporal_head import (
    TemporalHead, f32_convolutions, masked_cross_entropy)

#: optax adam's decay rates as float32 (train/optim.py::Optimizer.betas)
_BETAS = (float(np.float32(0.9)), float(np.float32(0.999)))


def train_temporal_head(embeddings, labels, *, epochs: int = 3000,
                        lr: float = 1e-5, seed: int = 0, init_params=None,
                        log_every: int = 0, device="cuda"):
    """Train on one full sequence on ``device``.

    Args:
      embeddings: (T, D) float per-frame embeddings.
      labels: (T,) int in {-1, 0, 1, 2}; -1 = ignore.
      init_params: optional warm start, a flax-keyed ``TemporalHead``
        tree (the JAX package's params, or a ``temporal_head.npz`` read by
        train/checkpoint.py::load_params_npz); a fresh init seeded from
        ``seed`` (a ``torch.Generator``, not ``jax.random``'s draw)
        otherwise.
    Returns (model, per-epoch losses as a float32 numpy array): the
    reference's final loss is ``losses[-1]``."""
    dev = resolve_device(device)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32))[None].to(dev)
    y = torch.as_tensor(np.asarray(labels, np.int64))[None].to(dev)
    model = TemporalHead(emb.shape[-1],
                         generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        model.load_state_dict(convert.temporal_head_to_state_dict(
            init_params))
    model = model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=_BETAS,
                           eps=1e-8)
    losses = torch.empty(epochs, device=dev)
    with f32_convolutions():
        for i in range(epochs):
            loss = masked_cross_entropy(model(emb), y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
    losses = losses.cpu().numpy()
    if log_every:
        for i in range(0, epochs, log_every):
            print(f"epoch {i} loss {losses[i]:.4f}")
    return model.eval(), losses


@torch.no_grad()
def predict_probs(model: TemporalHead, embeddings) -> np.ndarray:
    """(T, D) -> (T, 3) softmax probabilities, on the model's device
    (nba_proj/smarter_generate_clips.py:274-283)."""
    dev = next(model.parameters()).device
    emb = torch.as_tensor(np.asarray(embeddings, np.float32))[None].to(dev)
    return torch.softmax(model.eval()(emb)[0], dim=-1).cpu().numpy()
