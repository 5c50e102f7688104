"""One-shot weight writers.

Port of vit_research_tpu/db/writers.py, the reference's init scripts:

- :func:`init_projection_head`: a fresh 768 -> 768 ProjectionHead whose
  initial weights are saved (nba_proj/models/init_proj_head.py:9-17);
- the random-ViT weight artifact that six pipeline stages load
  (``vit_random_weights.h5``: nba_proj/write_embeddings.py:243,
  nba_proj/chroma.py:159, nba_proj/finalize_clips.py:125), here
  :func:`save_random_vit_weights` / :func:`load_random_vit_weights` for
  ``VIT_P32_432x768``.

Files are ``.npz`` under the flax trees' keys
(train/checkpoint.py::save_params_npz, through models/convert.py), so
either package loads the other's. The port's seeded weights come from a
``torch.Generator`` and are not the JAX package's ``jax.random`` draw for
the same seed (models/vit.py says the same of the backbone): the same
weights cross only as a file.
"""

from __future__ import annotations

import torch

from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models.heads import ProjectionHead
from vit_research_tpu_torch.train.checkpoint import (load_params_npz,
                                                     save_params_npz)
from vit_research_tpu_torch.utils.configs import VIT_P32_432x768, ViTConfig


def init_projection_head(path: str, *, input_dim: int = 768,
                         hidden_dim: int = 768, proj_dim: int = 768,
                         seed: int = 0) -> ProjectionHead:
    """Create a seeded ProjectionHead, save its weights to ``path``, and
    return it."""
    model = ProjectionHead(input_dim, hidden_dim=hidden_dim,
                           proj_dim=proj_dim,
                           generator=torch.Generator().manual_seed(seed))
    save_params_npz(convert.projection_head_to_params(model.state_dict()),
                    path)
    return model


def save_random_vit_weights(path: str, *, config: ViTConfig | None = None,
                            seed: int = 0):
    """Persist the seeded random-ViT feature space (models/vit.py::
    init_vit on the CPU) to ``path``; returns the model."""
    from vit_research_tpu_torch.models.vit import init_vit

    config = config or VIT_P32_432x768
    model = init_vit(config, seed=seed, device="cpu")
    save_params_npz(convert.state_dict_to_params(model.state_dict(), config),
                    path)
    return model


def load_random_vit_weights(path: str, *, config: ViTConfig | None = None,
                            device="cuda"):
    """The ViT of ``config`` (``VIT_P32_432x768`` by default) with the
    weights of ``path``, a file of either package, on ``device`` (the
    card by default: raises without one, like every entry point)."""
    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.models.vit import init_vit

    dev = resolve_device(device)
    config = config or VIT_P32_432x768
    model = init_vit(config, seed=0, device="cpu")
    template = convert.state_dict_to_params(model.state_dict(), config)
    model.load_state_dict(convert.params_to_state_dict(
        load_params_npz(template, path), config))
    return model.to(dev)
