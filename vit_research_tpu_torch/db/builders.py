"""Vector-store builders and the periodic rebuilders.

Port of vit_research_tpu/db/builders.py. Each builder takes callables
(embed, project, encode) on host arrays, so any engine or head plugs in:

- :func:`write_labeled_frame_collection` (write-frame-db): manually
  labelled frame embeddings with one-hot probability metadata
  (reference: nba_proj/write_per_vid_embeddings_chroma.py:203-278);
- :func:`write_class_npz` (write-embeddings);
- :func:`write_ratt_chunk_db` (write-ratt-db): chunk-encoder embeddings
  from the frame store;
- :func:`write_frame_ragdb` (write-rag-db): the frame-level RAG DB, with
  optional enrichment and projection (reference:
  nba_proj/write_clips_to_ragdb.py:296-391);
- :func:`wipe_collection`, :func:`rebuild_frame_db` (rebuild-db, train-rag
  --rebuild sync): wipe, re-embed, re-project through the current
  ProjectionHead, upsert (reference:
  nba_proj/db_maintainence/db_rebuild.py:100-232);
- :func:`rebuild_chunk_db`: chunk rows from 2304-d pooled statistics
  through a 2304 -> 768 projector (reference:
  nba_proj/db_maintainence/db_rebuild_chunk.py:191-290);
- :func:`reproject_chunk_rows` (train-ratt --rebuild sync): fresh
  embeddings for the ``chunk_<i>`` rows, their metadata kept.
"""

from __future__ import annotations

import numpy as np

from vit_research_tpu_torch.data import naming
from vit_research_tpu_torch.db.enrich import chunk_stats
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


def _frame_num(path: str) -> int:
    return naming.frame_num(path.rsplit("/", 1)[-1])


def write_frame_ragdb(samples, embed_fn, collection, *, enricher=None,
                      project_fn=None, batch_size: int = 256) -> int:
    """Frame-level RAG DB write: per-frame sample dicts (data/samples.py
    load_samples) -> rows keyed by frame path with side, t_norm, clip_num
    and vid_num metadata.

    ``embed_fn(paths) -> (n, D)``; ``enricher`` (db/enrich.py Enricher)
    and ``project_fn`` (e.g. a trained ProjectionHead) apply in that order
    when given. Returns the rows upserted."""
    total = 0
    max_frame_idx = None
    if enricher is not None:
        # one corpus-wide normaliser: the index encoding must not depend on
        # the batching (db/enrich.py)
        max_frame_idx = max((_frame_num(s["pth"]) for s in samples),
                            default=1)
    for _, batch in _batched(samples, batch_size):
        paths = [s["pth"] for s in batch]
        embs = np.asarray(embed_fn(paths), np.float32)
        if enricher is not None:
            embs = enricher(embs, [s["t_norm"] for s in batch],
                            [s["side"] for s in batch],
                            [_frame_num(p) for p in paths],
                            max_frame_idx=max_frame_idx)
        if project_fn is not None:
            embs = np.asarray(project_fn(embs), np.float32)
        metas = [{
            "side": s["side"], "t_norm": float(s["t_norm"]),
            "clip_num": int(s["clip_num"]), "vid_num": int(s["vid_num"]),
        } for s in batch]
        collection.upsert(paths, embs, metas)
        total += len(batch)
    return total


def wipe_collection(collection) -> None:
    """Empty a collection before a rebuild: every row goes (the reference
    spared a sentinel, ``where vid_num != 'vid0'``,
    nba_proj/db_maintainence/db_rebuild.py:121; no rebuild here keeps
    one)."""
    collection.delete(where={})


def rebuild_frame_db(samples, embed_fn, project_fn, collection, *,
                     enricher=None, batch_size: int = 256) -> int:
    """The epoch-periodic frame-level rebuild: wipe, then
    :func:`write_frame_ragdb` through the current projection (the rows
    move under the retriever as the ProjectionHead trains)."""
    wipe_collection(collection)
    return write_frame_ragdb(samples, embed_fn, collection,
                             enricher=enricher, project_fn=project_fn,
                             batch_size=batch_size)


def _chunk_id(ch) -> str:
    return f"vid{ch['vid']}_clip{ch['clip']}_s{ch['start_idx']}"


def _chunk_meta(ch, include_label: bool = True) -> dict:
    m = {"vid_num": int(ch["vid"]), "clip_num": int(ch["clip"]),
         "side": ch["side"], "t_center": float(ch["t_center"]),
         "t_width": float(ch["t_width"]),
         "start_idx": int(ch["start_idx"]), "end_idx": int(ch["end_idx"])}
    if include_label:
        m["label"] = int(ch["label"])
    return m


def rebuild_chunk_db(chunk_samples, frame_embed_fn, project_fn, collection,
                     *, include_label: bool = True,
                     batch_size: int = 64) -> int:
    """Chunk-level rebuild from pooled statistics: per chunk, frame
    embeddings -> concat(mean, mean-delta, std-delta) (3D) -> projector
    -> upsert as ``vid<v>_clip<c>_s<start>`` with the chunk's metadata.
    Wipes the collection first; returns the rows written."""
    wipe_collection(collection)
    total = 0
    for _, batch in _batched(chunk_samples, batch_size):
        frame_paths = [p for ch in batch for p in ch["frames"]]
        t = len(batch[0]["frames"])
        embs = np.asarray(frame_embed_fn(frame_paths), np.float32)
        stats = chunk_stats(embs.reshape(len(batch), t, -1))
        proj = np.asarray(project_fn(stats), np.float32)
        collection.upsert([_chunk_id(ch) for ch in batch], proj,
                          [_chunk_meta(ch, include_label) for ch in batch])
        total += len(batch)
    return total


def reproject_chunk_rows(chunks, frame_embs_fn, project_fn, collection, *,
                         batch_size: int = 256) -> int:
    """Fresh embeddings for the ``chunk_<i>`` rows of
    :func:`write_ratt_chunk_db` from a live chunk projection
    ``project_fn((B, T, D) frame embeddings) -> (B, D)`` (L2-normalised),
    keeping each stored row's metadata (its ``class_logit`` too); rows the
    collection lacks get the chunk's metadata.

    Positional ids are meaningful only for a collection written from the
    same store and chunking: a stored row whose (vid_num, start_idx), or
    a missing one, disagrees with the chunk at its position raises
    ValueError rather than mix embeddings and metadata."""
    total = 0
    for s in range(0, len(chunks), batch_size):
        batch = chunks[s:s + batch_size]
        ids = [f"chunk_{i}" for i in range(s, s + len(batch))]
        z = np.array(project_fn(
            np.asarray(frame_embs_fn(batch), np.float32)), np.float32)
        z /= (np.linalg.norm(z, axis=1, keepdims=True) + 1e-8)
        got = collection.get(ids=ids)
        by_id = dict(zip(got.get("ids", []), got.get("metadatas") or []))
        metas = []
        for cid, ch in zip(ids, batch):
            m = by_id.get(cid)
            if m is None:
                m = _chunk_meta(ch)
            elif (int(m.get("vid_num", -1)) != int(ch["vid"])
                    or int(m.get("start_idx", -1)) != int(ch["start_idx"])):
                raise ValueError(
                    f"collection row {cid} (vid {m.get('vid_num')}, start "
                    f"{m.get('start_idx')}) does not match the store's "
                    f"chunk at that position (vid {ch['vid']}, start "
                    f"{ch['start_idx']}): the chunk index and the "
                    "collection come from different stores or chunkings "
                    "— refusing to mix embeddings and metadata")
            metas.append(m)
        collection.upsert(ids, z, metas)
        total += len(batch)
    return total
