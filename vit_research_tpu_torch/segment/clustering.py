"""Embedding-space clustering study + MLP side classifier.

Port of vit_research_tpu/segment/clustering.py (reference:
nba_proj/clustering.py, clustering_per_vid.py):

- class-mean embedding separation distances, the calibration check for
  the random-ViT feature space (reference: nba_proj/clustering.py:43-49);
- KMeans seeded with class-mean centroids (reference: :69-93), on the
  host as in the JAX package: sklearn with ``init=centroids`` where it is
  installed, else the numpy Lloyd iteration below;
- an MLP side classifier fc1 512 -> ReLU -> fc2 128 -> ReLU -> out, with
  inverse-frequency class weights (reference: :130-160), trained on a
  torch device; its weights save in the JAX package's npz format
  (train/checkpoint.py, models/convert.py::side_mlp_to_params).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.vit import _lecun_normal_

SIDES = ("left", "right", "none")


def class_mean_separation(embeddings, labels) -> dict:
    """Pairwise L2 distances between class-mean embeddings."""
    embeddings = np.asarray(embeddings)
    labels = np.asarray(labels)
    means = {c: embeddings[labels == c].mean(axis=0)
             for c in np.unique(labels)}
    out = {}
    keys = sorted(means)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            out[(int(a), int(b))] = float(np.linalg.norm(means[a] - means[b]))
    return out


def kmeans_with_class_means(embeddings, labels, *, n_iter: int = 50):
    """KMeans initialized at the class means, on the host. Returns
    (centroids, assignments)."""
    embeddings = np.asarray(embeddings, np.float64)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    centroids = np.stack([embeddings[labels == c].mean(axis=0)
                          for c in classes])
    try:
        from sklearn.cluster import KMeans
    except ImportError:
        return _lloyd(embeddings, centroids, n_iter)
    km = KMeans(n_clusters=len(classes), init=centroids, n_init=1,
                max_iter=n_iter)
    assign = km.fit_predict(embeddings)
    return km.cluster_centers_, assign


def _lloyd(embeddings, centroids, n_iter: int):
    """The reference's numpy Lloyd iteration (its route without sklearn)."""
    for _ in range(n_iter):
        d = ((embeddings[:, None, :] - centroids[None]) ** 2).sum(-1)
        assign = d.argmin(axis=1)
        for c in range(len(centroids)):
            sel = assign == c
            if sel.any():
                centroids[c] = embeddings[sel].mean(axis=0)
    return centroids, assign


class SideMLP(nn.Module):
    """fc1 512 -> ReLU -> fc2 128 -> ReLU -> out ``num_classes`` logits;
    the JAX package's Flax ``SideMLP`` with the same layer names and its
    Dense init (LeCun truncated normal, zero bias)."""

    def __init__(self, in_dim: int, num_classes: int = 3, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 512)
        self.fc2 = nn.Linear(512, 128)
        self.out = nn.Linear(128, num_classes)
        with torch.no_grad():
            for mod in (self.fc1, self.fc2, self.out):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.out(x)


def train_side_classifier(embeddings, labels, *, device,
                          num_epochs: int = 50, batch_size: int = 64,
                          lr: float = 1e-3, seed: int = 0,
                          class_weights=None):
    """Train a :class:`SideMLP` on ``device``; returns (model, history).

    Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8), the mean of
    the class-weighted cross-entropy per batch, and the JAX package's batch
    order (``np.random.default_rng(seed).permutation`` each epoch, whole
    batches only). ``class_weights`` defaults to inverse frequency. The
    init is drawn from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    x_np = np.asarray(embeddings, np.float32)
    y_np = np.asarray(labels, np.int64)
    n_classes = int(y_np.max()) + 1
    if class_weights is None:
        counts = np.bincount(y_np, minlength=n_classes).astype(np.float64)
        class_weights = counts.sum() / np.maximum(counts * n_classes, 1)
    cw = torch.as_tensor(np.asarray(class_weights, np.float32), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = SideMLP(x_np.shape[1], n_classes, generator=gen).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)

    rng = np.random.default_rng(seed)
    history = []
    for _ in range(num_epochs):
        idx = rng.permutation(len(x_np))
        losses, accs = [], []
        for s in range(0, len(x_np) - batch_size + 1, batch_size):
            b = torch.from_numpy(idx[s:s + batch_size]).to(dev)
            xb, yb = x[b], y[b]
            logits = model(xb)
            loss = (F.cross_entropy(logits, yb, reduction="none")
                    * cw[yb]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            acc = (logits.argmax(-1) == yb).float().mean()
            losses.append(loss.detach())
            accs.append(acc)
        history.append({
            "loss": float(np.mean([float(v) for v in losses] or [0])),
            "acc": float(np.mean([float(v) for v in accs] or [0]))})
    return model.eval(), history


@torch.no_grad()
def classify_sides(model: SideMLP, embeddings, *, device) -> np.ndarray:
    """Argmax side index per row, with ``model`` on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    return model.to(dev)(x).argmax(-1).cpu().numpy()
