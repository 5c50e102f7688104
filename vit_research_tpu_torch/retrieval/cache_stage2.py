"""The stage-2 per-chunk retrieval cache: sim / contrast / temporal
branches.

Port of vit_research_tpu/retrieval/cache_stage2.py. Entries are numpy
arrays and plain dicts, as the JAX package's cache holds them, so a cache
pickled by either package loads in the other:

- every chunk is encoded once by the frozen stage-1 ChunkEncoder (the
  caller's ``encode_fn``; on a CUDA device kernel B at dh = 96);
- the ``future`` chunk is the chunk ``future_step`` windows ahead in the
  same (vid, clip), clamped to the clip's last chunk;
- **sim**: the top ``k_sim`` same-side, same-label neighbours of the
  chunk's own embedding; **contrast**: the top ``k_contrast`` same-side,
  different (known) label; **temporal**: the top ``k_temporal``
  same-side neighbours of the future chunk's embedding; each with
  self-exclusion and signature dedup, padded with zero rows and a PAD
  meta;
- two store queries a chunk (content, then temporal), in chunk order:
  the store ranks ties as the JAX package's does (a stable descending
  order), so the branches select the same rows;
- the cache is pickled with periodic checkpoints; validation runs the
  same selection live against the current collection
  (``fetch_live_batch``).
"""

from __future__ import annotations

import os

import numpy as np

from vit_research_tpu_torch.retrieval.cache_io import load_cache, save_cache

#: decimals of t_center in a dedup signature (the JAX package's
#: retrieval/cache_bins.py KEY_PRECISION)
KEY_PRECISION = 5

PAD_META = {
    "label": -1, "side": "PAD", "vid": -1, "clip": -1,
    "t_center": -1.0, "t_width": -1.0, "start_idx": -1, "end_idx": -1,
}


def make_chunk_key(chunk) -> tuple:
    return (int(chunk["vid"]), int(chunk["clip"]), int(chunk["start_idx"]))


def normalize_meta(meta) -> dict:
    """Raw collection metadata (``vid_num`` / ``clip_num`` keys, possibly
    without a label) -> PAD_META's key schema."""
    return {
        "label": int(meta.get("label", -1)),
        "side": str(meta.get("side", "PAD")),
        "vid": int(meta.get("vid_num", meta.get("vid", -1))),
        "clip": int(meta.get("clip_num", meta.get("clip", -1))),
        "t_center": float(meta.get("t_center", -1.0)),
        "t_width": float(meta.get("t_width", -1.0)),
        "start_idx": int(meta.get("start_idx", -1)),
        "end_idx": int(meta.get("end_idx", -1)),
    }


def dedup_signature(meta) -> tuple:
    return (int(meta["vid"]), round(float(meta["t_center"]), KEY_PRECISION))


def same_chunk_meta(query_meta, cand_meta) -> bool:
    return (int(query_meta["vid"]) == int(cand_meta["vid"])
            and int(query_meta["clip"]) == int(cand_meta["clip"])
            and int(query_meta["start_idx"]) == int(cand_meta["start_idx"]))


def build_future_lookup(all_chunks, future_step: int) -> dict:
    """chunk key -> key of the chunk ``future_step`` windows ahead in its
    clip, clamped to the clip's last chunk (end-of-clip chunks use the
    last chunk, possibly themselves, never a zero embedding)."""
    by_clip: dict = {}
    for ch in all_chunks:
        by_clip.setdefault((int(ch["vid"]), int(ch["clip"])), []).append(ch)
    lookup = {}
    for chunks in by_clip.values():
        keys = [make_chunk_key(c) for c in
                sorted(chunks, key=lambda c: int(c["start_idx"]))]
        for i, k in enumerate(keys):
            lookup[k] = keys[min(i + future_step, len(keys) - 1)]
    return lookup


def _meta_from_chunk(ch) -> dict:
    return {
        "label": int(ch["label"]), "side": str(ch["side"]),
        "vid": int(ch["vid"]), "clip": int(ch["clip"]),
        "t_center": float(ch["t_center"]), "t_width": float(ch["t_width"]),
        "start_idx": int(ch["start_idx"]), "end_idx": int(ch["end_idx"]),
    }


def _pad_or_trim(items, k, dim):
    embs = np.zeros((k, dim), np.float32)
    metas = [dict(PAD_META) for _ in range(k)]
    for i, it in enumerate(items[:k]):
        embs[i] = it["emb"]
        metas[i] = it["meta"]
    return embs, metas


def _select_branch(candidates, query_meta, *, want, k, dim,
                   q_label=None, exclude_self=True,
                   near_self_emb=None, self_sim_cap=0.9999):
    """The first ``k`` candidates, in rank order, of the query's side and
    of label relation ``want`` ('same' | 'diff' | 'any'), one a dedup
    signature; zero rows and PAD metas after them.

    ``q_label`` overrides the query's label for the relation test only.
    ``exclude_self`` drops the candidate with the query's own (vid, clip,
    start_idx); pass False for queries that are not in the collection
    (live chunks), whose session-local coordinates can collide with
    unrelated rows. ``near_self_emb`` is the live analogue: candidates at
    cosine >= ``self_sim_cap`` to it are dropped (a game already in the
    collection would return its stored twin at cosine ~1.0). Unlabelled
    candidates (label -1) are never contrast rows: their label is
    unknown, not different."""
    items, seen = [], set()
    if q_label is None:
        q_label = int(query_meta["label"])
    if near_self_emb is not None:
        ns = np.asarray(near_self_emb, np.float32)
        ns = ns / (np.linalg.norm(ns) + 1e-8)
    for cand in candidates:
        m = cand["meta"]
        if exclude_self and same_chunk_meta(query_meta, m):
            continue
        if near_self_emb is not None:
            ce = np.asarray(cand["emb"], np.float32)
            cos = float(np.dot(ce, ns)) / (float(np.linalg.norm(ce)) + 1e-8)
            if cos >= self_sim_cap:
                continue
        if str(m["side"]) != str(query_meta["side"]):
            continue
        sig = dedup_signature(m)
        if sig in seen:
            continue
        lbl = int(m["label"])
        if want == "same" and lbl != q_label:
            continue
        if want == "diff" and (lbl == q_label or lbl < 0):
            continue
        items.append(cand)
        seen.add(sig)
        if len(items) >= k:
            break
    return _pad_or_trim(items, k, dim)


def _query(collection, emb, search_k):
    res = collection.query(query_embeddings=np.asarray(emb, np.float32),
                           n_results=search_k,
                           include=("embeddings", "metadatas"))
    return [{"emb": np.asarray(e, np.float32), "meta": normalize_meta(m)}
            for e, m in zip(res["embeddings"][0], res["metadatas"][0])]


def build_live_entry(chunk, query_emb, future_emb, collection, *,
                     k_sim: int, k_contrast: int, k_temporal: int,
                     search_k_content: int = 64,
                     search_k_temporal: int = 32,
                     exclude_self: bool = True,
                     self_sim_cap: float | None = None) -> dict:
    """One chunk's sim / contrast / temporal branches against the current
    collection: two queries, content (``query_emb``) then temporal
    (``future_emb``).

    ``chunk['retrieval_label']``, when present, stands in for the label in
    branch selection only (the entry's ``query_meta['label']``, exported
    as ``labels`` by ``_stack_entries``, stays the true one): a live,
    unlabelled query selects with the stage-1 proxy label. ``exclude_self``
    and ``self_sim_cap`` as in ``_select_branch``; the cap drops only the
    query's twin, in every branch."""
    dim = int(np.shape(query_emb)[-1])
    query_meta = _meta_from_chunk(chunk)
    q_label = int(chunk.get("retrieval_label", query_meta["label"]))
    sel = dict(q_label=q_label, exclude_self=exclude_self,
               near_self_emb=query_emb if self_sim_cap is not None else None,
               self_sim_cap=self_sim_cap if self_sim_cap is not None
               else 0.9999)

    content = _query(collection, query_emb, search_k_content)
    sim_embs, sim_meta = _select_branch(content, query_meta, want="same",
                                        k=k_sim, dim=dim, **sel)
    con_embs, con_meta = _select_branch(content, query_meta, want="diff",
                                        k=k_contrast, dim=dim, **sel)
    temporal = _query(collection, future_emb, search_k_temporal)
    tmp_embs, tmp_meta = _select_branch(temporal, query_meta, want="any",
                                        k=k_temporal, dim=dim, **sel)
    return {
        "query_emb": np.asarray(query_emb, np.float32),
        "future_emb": np.asarray(future_emb, np.float32),
        "query_meta": query_meta,
        "sim_embs": sim_embs, "sim_meta": sim_meta,
        "contrast_embs": con_embs, "contrast_meta": con_meta,
        "temporal_embs": tmp_embs, "temporal_meta": tmp_meta,
    }


def build_stage2_cache(all_chunks, encode_fn, collection, *,
                       k_sim: int, k_contrast: int, k_temporal: int,
                       future_step: int = 2, search_k_content: int = 64,
                       search_k_temporal: int = 32,
                       checkpoint_path: str | None = None,
                       checkpoint_every: int = 100,
                       verbose: bool = False) -> dict:
    """The full cache: chunk key -> ``build_live_entry``'s entry.

    ``encode_fn(chunk) -> (D,)`` is the frozen stage-1 encoder. Periodic
    checkpoints go to ``checkpoint_path + ".partial"`` and only the
    complete cache to ``checkpoint_path``, so an existing cache file is
    always a finished build, and a rerun resumes from the partial file."""
    keys = [make_chunk_key(ch) for ch in all_chunks]
    embs = {k: np.asarray(encode_fn(ch), np.float32)
            for k, ch in zip(keys, all_chunks)}
    future = build_future_lookup(all_chunks, future_step)

    partial_path = checkpoint_path + ".partial" if checkpoint_path else None
    cache: dict = {}
    if partial_path and os.path.exists(partial_path):
        cache = load_cache(partial_path)
        if verbose:
            print(f"[CACHE] resuming from {partial_path} "
                  f"({len(cache)} entries)")
    for i, (key, chunk) in enumerate(zip(keys, all_chunks)):
        if key in cache:
            continue
        query_emb = embs[key]
        next_key = future.get(key)
        future_emb = (np.zeros_like(query_emb) if next_key is None
                      else embs[next_key])
        cache[key] = build_live_entry(
            chunk, query_emb, future_emb, collection,
            k_sim=k_sim, k_contrast=k_contrast, k_temporal=k_temporal,
            search_k_content=search_k_content,
            search_k_temporal=search_k_temporal)
        if verbose and (i + 1) % 10 == 0:
            print(f"[CACHE] built {i + 1}/{len(all_chunks)}")
        if partial_path and (i + 1) % checkpoint_every == 0:
            save_cache(cache, partial_path)
    if checkpoint_path:
        save_cache(cache, checkpoint_path)
        if partial_path and os.path.exists(partial_path):
            os.remove(partial_path)
    return cache


def fetch_cache_batch(cache, chunks) -> dict:
    """A batch of cached entries -> dict of stacked arrays."""
    return _stack_entries([cache[make_chunk_key(ch)] for ch in chunks])


def fetch_live_batch(chunks, encode_fn, collection, *, k_sim, k_contrast,
                     k_temporal, future_step: int = 2,
                     search_k_content: int = 64, search_k_temporal: int = 32,
                     all_chunks=None, pool_embs: dict | None = None,
                     exclude_self: bool = True,
                     self_sim_cap: float | None = None) -> dict:
    """Live (uncached) retrieval for a batch: the validation route.

    ``all_chunks`` is the pool the future chunks come from (default: the
    batch). ``pool_embs`` (chunk key -> (D,) embedding) lets a caller that
    fetches many batches over one pool encode it once; without it each
    call encodes the whole pool."""
    pool = all_chunks if all_chunks is not None else chunks
    future = build_future_lookup(pool, future_step)
    embs = (pool_embs if pool_embs is not None
            else {make_chunk_key(ch): np.asarray(encode_fn(ch), np.float32)
                  for ch in pool})
    entries = []
    for ch in chunks:
        key = make_chunk_key(ch)
        next_key = future.get(key)
        future_emb = (np.zeros_like(embs[key]) if next_key is None
                      else embs.get(next_key, np.zeros_like(embs[key])))
        entries.append(build_live_entry(
            ch, embs[key], future_emb, collection,
            k_sim=k_sim, k_contrast=k_contrast, k_temporal=k_temporal,
            search_k_content=search_k_content,
            search_k_temporal=search_k_temporal,
            exclude_self=exclude_self, self_sim_cap=self_sim_cap))
    return _stack_entries(entries)


def _stack_entries(entries) -> dict:
    def meta_labels(key):
        return np.asarray([[int(m["label"]) for m in e[key]]
                           for e in entries], np.int32)

    return {
        "query_emb": np.stack([e["query_emb"] for e in entries]),
        "future_emb": np.stack([e["future_emb"] for e in entries]),
        "sim_embs": np.stack([e["sim_embs"] for e in entries]),
        "contrast_embs": np.stack([e["contrast_embs"] for e in entries]),
        "temporal_embs": np.stack([e["temporal_embs"] for e in entries]),
        "sim_labels": meta_labels("sim_meta"),
        "contrast_labels": meta_labels("contrast_meta"),
        "temporal_labels": meta_labels("temporal_meta"),
        "labels": np.asarray([int(e["query_meta"]["label"])
                              for e in entries], np.int32),
    }
