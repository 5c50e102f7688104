"""Chunk statistics over frame embeddings.

Port of ``chunk_stats`` from vit_research_tpu/db/enrich.py: the pooled
chunk descriptor the chunk-level databases are built from. The RAG
enrichment (``Enricher``) comes with the heads.
"""

from __future__ import annotations

import numpy as np


def chunk_stats(frame_embs) -> np.ndarray:
    """(B, T, D) -> (B, 3D) concat(mean, mean-delta, std-delta)
    (reference: nba_proj/db_maintainence/db_rebuild_chunk.py:226-232)."""
    x = np.asarray(frame_embs, np.float32)
    deltas = x[:, 1:] - x[:, :-1]
    return np.concatenate([
        x.mean(axis=1), deltas.mean(axis=1), deltas.std(axis=1)], axis=-1)
