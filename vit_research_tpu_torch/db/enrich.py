"""Frame-embedding enrichment and chunk statistics.

Port of vit_research_tpu/db/enrich.py:

- ``Enricher``: the RAG database's enriched frame rows (reference:
  nba_proj/write_clips_to_ragdb.py:156-224): the base embedding
  concatenated with a randomised-phase temporal sine encoding, a +/-1 side
  mask and a frame-index cosine encoding, weighted (0.4 / 0.15 / 0.35 /
  0.10) and projected back to ``hidden`` dims through a fixed Gaussian
  matrix. Phases and projection come from a seeded numpy generator, drawn
  in the JAX package's order, so one seed gives one enrichment space in
  both packages. Host numpy, as the reference.
- ``chunk_stats``: the pooled chunk descriptor (mean, mean-delta,
  std-delta; 3D wide) of the chunk-level databases, on the host, and
  ``chunk_stats_torch``, the same on a tensor for the RATT trainer's step.
"""

from __future__ import annotations

import numpy as np
import torch

ENRICH_DIM = 768
SIDE_DIM = 768
HIDDEN = 768
WEIGHTS = (0.4, 0.15, 0.35, 0.10)


class Enricher:
    def __init__(self, base_dim: int = 768, enrich_dim: int = ENRICH_DIM,
                 side_dim: int = SIDE_DIM, hidden: int = HIDDEN,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.enrich_dim = enrich_dim
        self.side_dim = side_dim
        self.temporal_freqs = np.linspace(5, 300, enrich_dim)
        self.temporal_phases = rng.uniform(0, 2 * np.pi, enrich_dim)
        self.index_freqs = np.linspace(1, 16, enrich_dim)
        total = base_dim + enrich_dim + side_dim + enrich_dim
        self.projection = rng.normal(
            0, 1 / np.sqrt(total), (total, hidden)).astype(np.float32)

    def temporal_encoding(self, t_norm) -> np.ndarray:
        """sin(2 pi f t^1.5 + phi): a nonlinear time warp, fast
        oscillation."""
        t = np.asarray(t_norm, np.float64)[..., None] ** 1.5
        return np.sin(2 * np.pi * self.temporal_freqs * t
                      + self.temporal_phases)

    def side_mask(self, sides) -> np.ndarray:
        s = np.asarray([1.0 if str(x) == "left" else -1.0 for x in sides])
        return np.tile(s[:, None], (1, self.side_dim))

    def frame_index_encoding(self, idx, total_frames) -> np.ndarray:
        t = np.asarray(idx, np.float64)[..., None] / max(total_frames, 1)
        return np.cos(2 * np.pi * self.index_freqs * t)

    def __call__(self, base_embs, t_norms, sides, frame_indices,
                 max_frame_idx: int | None = None) -> np.ndarray:
        """(B, base_dim) base embeddings + metadata -> (B, hidden).

        ``max_frame_idx`` normalises the frame index over the whole corpus;
        a batched writer must pass it (db/builders.py computes it once),
        or a frame's encoding would depend on its batch. Default: this
        call's largest index."""
        base = np.asarray(base_embs, np.float64)
        b = base.shape[0]
        max_idx = (int(max_frame_idx) if max_frame_idx
                   else (int(np.max(frame_indices)) if len(frame_indices)
                         else 1))
        w0, w1, w2, w3 = WEIGHTS
        concat = np.concatenate([
            w0 * base,
            w1 * self.temporal_encoding(t_norms).reshape(b, -1),
            w2 * self.side_mask(sides),
            w3 * self.frame_index_encoding(frame_indices, max_idx),
        ], axis=1).astype(np.float32)
        return concat @ self.projection


def chunk_stats(frame_embs) -> np.ndarray:
    """(B, T, D) -> (B, 3D) concat(mean, mean-delta, std-delta)
    (reference: nba_proj/db_maintainence/db_rebuild_chunk.py:226-232)."""
    x = np.asarray(frame_embs, np.float32)
    deltas = x[:, 1:] - x[:, :-1]
    return np.concatenate([
        x.mean(axis=1), deltas.mean(axis=1), deltas.std(axis=1)], axis=-1)


def chunk_stats_torch(frame_embs: torch.Tensor) -> torch.Tensor:
    """:func:`chunk_stats` on a tensor, on its device, differentiable
    (the population std, as numpy's)."""
    x = frame_embs.to(torch.float32)
    deltas = x[:, 1:] - x[:, :-1]
    return torch.cat([x.mean(dim=1), deltas.mean(dim=1),
                      deltas.std(dim=1, correction=0)], dim=-1)
