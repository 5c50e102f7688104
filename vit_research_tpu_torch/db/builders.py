"""Vector-store builders.

Port of the builders of vit_research_tpu/db/builders.py that the port's
verbs call: :func:`write_labeled_frame_collection` (write-frame-db),
manually labelled frame embeddings with one-hot probability metadata
(reference: nba_proj/write_per_vid_embeddings_chroma.py:203-278), and
:func:`write_class_npz` (write-embeddings). The builders of the RAG/RATT
databases come with the heads.
"""

from __future__ import annotations

import numpy as np


def _batched(items, size):
    for i in range(0, len(items), size):
        yield i, items[i:i + size]


def write_labeled_frame_collection(frames, labels, probs, embed_fn,
                                   collection, *, batch_size: int = 128) -> int:
    """Manually-labeled frames -> collection with label + per-class prob
    metadata; ids are the frame file names. Returns the rows upserted."""
    total = 0
    idx = list(range(len(frames)))
    for _, batch_idx in _batched(idx, batch_size):
        paths = [frames[i] for i in batch_idx]
        embs = np.asarray(embed_fn(paths), np.float32)
        metas = [{
            "label": str(labels[i]),
            "left_prob": float(probs[i][0]),
            "right_prob": float(probs[i][1]),
            "none_prob": float(probs[i][2]),
        } for i in batch_idx]
        collection.upsert([p.rsplit("/", 1)[-1] for p in paths], embs, metas)
        total += len(batch_idx)
    return total


def write_class_npz(frames_by_class, embed_fn, out_template: str) -> dict:
    """Per-class npz artifacts: ``embeddings`` (N, 1, D) and ``frame_ids``
    (reference: nba_proj/write_embeddings.py:177-243 wrote
    {left,right,none}_embeddings.npz). Returns {class: path}."""
    out = {}
    for cls, paths in frames_by_class.items():
        embs = np.asarray(embed_fn(paths), np.float32)
        path = out_template.format(cls=cls)
        np.savez(path, embeddings=embs[:, None, :],
                 frame_ids=np.asarray([p.rsplit("/", 1)[-1] for p in paths],
                                      dtype=str))
        out[cls] = path
    return out
