"""Vector-store builders.

Port of the builders of vit_research_tpu/db/builders.py that the port's
verbs call: :func:`write_labeled_frame_collection` (write-frame-db),
manually labelled frame embeddings with one-hot probability metadata
(reference: nba_proj/write_per_vid_embeddings_chroma.py:203-278),
:func:`write_class_npz` (write-embeddings) and :func:`write_ratt_chunk_db`
(write-ratt-db), chunk-encoder embeddings from the frame store. The RAG
database writers and the periodic rebuilds come with the retrieval
trainers.
"""

from __future__ import annotations

import numpy as np

from vit_research_tpu_torch.db.frame_store import gather_chunk_embedding_batch


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


def write_ratt_chunk_db(chunk_index, store, encode_fn, collections, *,
                        batch_size: int = 256,
                        l2_normalize: bool = True) -> int:
    """Chunk-encoder embeddings into the RATT collections.

    Args:
      chunk_index: dict from db/frame_store.py build_chunk_index or
        load_chunk_index.
      store: the FrameStore the index points into.
      encode_fn: callable((B, T, D) frame embeddings) -> (chunk_embs
        (B, D), class_logits (B, 1)): the frozen ChunkEncoder.
      collections: one collection or several (each gets every row).
    Rows are ``chunk_<i>`` with the chunk's metadata and class logit,
    L2-normalised unless ``l2_normalize`` is False. Returns the rows
    written."""
    if not isinstance(collections, (list, tuple)):
        collections = [collections]
    n = len(chunk_index["label"])
    total = 0
    for start in range(0, n, batch_size):
        ids_range = np.arange(start, min(start + batch_size, n))
        frame_embs = gather_chunk_embedding_batch(store, chunk_index,
                                                  ids_range)
        chunk_embs, class_logits = encode_fn(frame_embs)
        chunk_embs = np.array(chunk_embs, np.float32)  # writable copy
        if l2_normalize:
            chunk_embs /= (np.linalg.norm(chunk_embs, axis=1, keepdims=True)
                           + 1e-8)
        logits = np.asarray(class_logits).reshape(-1)
        ids = [f"chunk_{i}" for i in ids_range]
        metas = [{
            "vid_num": int(chunk_index["vid"][i]),
            "clip_num": int(chunk_index["clip"][i]),
            "side": str(chunk_index["side"][i]),
            "label": int(chunk_index["label"][i]),
            "t_center": float(chunk_index["t_center"][i]),
            "t_width": float(chunk_index["t_width"][i]),
            "class_logit": float(logits[j]),
            "start_idx": int(chunk_index["start_idx"][i]),
            "end_idx": int(chunk_index["end_idx"][i]),
        } for j, i in enumerate(ids_range)]
        for col in collections:
            col.upsert(ids, chunk_embs, metas)
        total += len(ids_range)
    return total
