"""Label-conditioned retrieval cache with greedy diversity selection.

Port of vit_research_tpu/retrieval/cache_bins.py (the cached-retrieval
mode of the reference, nba_proj/train/training_chunk_cached.py:106-469,
706-777). The cache holds numpy arrays and plain dicts keyed by
``(side, coarse_time_bin, label)``, as the JAX package's does, so a cache
pickled by either package loads in the other:

- chunks group into ``(side, coarse_time_bin, label)`` bins;
- up to 3 anchors per bin, preferring distinct videos;
- one mega-query per bin (query_mult * C results) filtered to the train
  videos and the bin's side, through the port's store on the
  collection's device (its routing is the reference's; ties rank in a
  stable descending order, as the JAX store's);
- candidates merge across anchors keeping the best score per signature
  ``(vid, side, round(t_center, 5))``;
- positives (same label) and hard negatives (different known label) split
  by a ``hard_negative_ratio`` quota, each chosen on the host by **greedy
  diversity selection** (per-video caps, global appearance caps, minimum
  time gaps and a ``lambda_global`` frequency penalty), with cross-side
  backfill;
- consumers look up their bin, mask same-video rows, trim to top_k and
  pad with zeros / -1 flags.

All randomness is seeded numpy, drawn in the JAX package's order.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from vit_research_tpu_torch.retrieval.cache_io import (  # noqa: F401
    load_cache, save_cache)
from vit_research_tpu_torch.retrieval.cache_stage2 import KEY_PRECISION


def coarse_time_bin(t_center: float, delta: float = 0.1) -> int:
    # Quantize through float32 FIRST: the cache is built from the chunk
    # dicts' float64 t_center but looked up with float32 metadata
    # columns (train/common.py chunk_metadata_batch), and floor division
    # flips bins across that roundtrip (0.2 // 0.1 == 1.0 in float64 but
    # 2.0 after a float32 roundtrip). Normalizing both sides to float32
    # makes build and lookup keys agree for every value.
    return int(float(np.float32(t_center)) // delta)


def make_key(vid, side, t_center) -> tuple:
    return (int(vid), str(side), round(float(t_center), KEY_PRECISION))


def greedy_select_candidates(candidates, k, global_counts, *,
                             max_per_video: int, max_global_appearances: int,
                             min_time_gap: float,
                             lambda_global: float = 0.5,
                             video_counts: dict | None = None,
                             video_times=None) -> list:
    """Pick up to k candidates maximizing (base_score - lambda * global
    frequency) subject to diversity constraints. Mutates global_counts.

    ``video_counts`` / ``video_times`` let a caller carry per-video caps
    and time-gap state across multiple calls (e.g. a quota backfill must
    honor the constraints against the already-kept set, not restart
    them); both are mutated."""
    kept = []
    selected = set()
    video_counts = {} if video_counts is None else video_counts
    video_times = {} if video_times is None else video_times  # any mapping

    # One sweep in descending adjusted-score order is equivalent to the
    # naive pick-the-global-max loop: within a call the adjusted scores
    # are static (a pick only bumps global_counts for its OWN sig, and a
    # same-sig duplicate is skipped via ``selected`` anyway) and every
    # constraint is monotone — a candidate rejected now can never become
    # eligible later. O(n log n + k·checks) instead of O(k·n).
    order = sorted(
        range(len(candidates)),
        key=lambda i: (-(candidates[i]["base_score"]
                         - lambda_global * global_counts[candidates[i]["sig"]]),
                       i))
    for i in order:
        if len(kept) >= k:
            break
        cand = candidates[i]
        sig = cand["sig"]
        if sig in selected:
            continue
        if video_counts.get(cand["vid"], 0) >= max_per_video:
            continue
        if global_counts[sig] >= max_global_appearances:
            continue
        if any(abs(cand["t_center"] - t) < min_time_gap
               for t in video_times.get(cand["vid"], ())):
            continue
        kept.append(cand)
        selected.add(sig)
        video_counts[cand["vid"]] = video_counts.get(cand["vid"], 0) + 1
        video_times.setdefault(cand["vid"], []).append(cand["t_center"])
        global_counts[sig] += 1
    return kept


def _empty_pool(dim: int = 768) -> dict:
    return {
        "embeddings": np.zeros((0, dim), np.float32),
        "vid": np.zeros((0,), np.int32),
        "side": np.asarray([], dtype=object),
        "t_center": np.zeros((0,), np.float32),
        "label": np.zeros((0,), np.int32),
        "is_hard_negative": np.zeros((0,), np.int32),
    }


def build_bin_cache(all_chunks, embed_anchor_fn, collection, *,
                    train_vids, candidates_per_bin: int = 20,
                    query_mult: int = 100, max_per_video: int = 100,
                    max_global_appearances: int = 5,
                    min_time_gap: float = 0.01,
                    hard_negative_ratio: float = 0.30,
                    lambda_global: float = 0.1,
                    num_anchors_per_bin: int = 3,
                    delta_t: float = 0.1, seed: int = 1234,
                    verbose: bool = False) -> dict:
    """Build the (side, bin, label) -> candidate-pool cache.

    Args:
      all_chunks: chunk dicts (data/chunks.build_chunks schema).
      embed_anchor_fn: callable(chunk dict) -> (D,) query embedding in the
        collection's space (frozen ChunkEncoder [+ proj head]).
    """
    rng = np.random.default_rng(seed)
    c = candidates_per_bin
    cache: dict = {}

    label_lookup = {make_key(ch["vid"], ch["side"], ch["t_center"]):
                    int(ch["label"]) for ch in all_chunks}
    bins = defaultdict(list)
    for ch in all_chunks:
        bins[(ch["side"], coarse_time_bin(ch["t_center"], delta_t),
              int(ch["label"]))].append(ch)

    total_count = collection.count()
    global_counts: Counter = Counter()
    train_vid_nums = [int(v) for v in train_vids]

    items = list(bins.items())
    rng.shuffle(items)

    for (side, bin_id, anchor_label), chunks_in_bin in items:
        shuf = list(chunks_in_bin)
        rng.shuffle(shuf)
        by_vid = defaultdict(list)
        for ch in shuf:
            by_vid[int(ch["vid"])].append(ch)
        vids_order = list(by_vid)
        rng.shuffle(vids_order)
        anchors = [by_vid[v][0] for v in vids_order[:num_anchors_per_bin]]
        if len(anchors) < num_anchors_per_bin:
            used = {id(a) for a in anchors}
            for ch in shuf:
                if len(anchors) >= num_anchors_per_bin:
                    break
                if id(ch) not in used:
                    anchors.append(ch)
                    used.add(id(ch))
        if not anchors or total_count == 0:
            cache[(side, bin_id, anchor_label)] = _empty_pool()
            continue

        anchor_embs = np.stack([np.asarray(embed_anchor_fn(a), np.float32)
                                for a in anchors])
        raw_n = min(query_mult * c, total_count)
        result = collection.query(
            query_embeddings=anchor_embs, n_results=raw_n,
            where={"$and": [{"side": {"$eq": side}},
                            {"vid_num": {"$in": train_vid_nums}}]},
            include=("embeddings", "metadatas", "distances"))

        merged: dict = {}
        for q in range(len(anchors)):
            embs = np.asarray(result["embeddings"][q], np.float32)
            metas = result["metadatas"][q]
            dists = result["distances"][q]
            for rank, (emb, m, dist) in enumerate(zip(embs, metas, dists)):
                vid = int(m["vid_num"])
                t_center = float(m["t_center"])
                # The signature IS the cache key scheme — one builder,
                # so sig and the label_lookup keys can never desync.
                sig = make_key(vid, side, t_center)
                base_score = -float(rank) if dist is None else -float(dist)
                prev = merged.get(sig)
                if prev is None or base_score > prev["base_score"]:
                    merged[sig] = {
                        "emb": emb, "vid": vid, "side": side,
                        "t_center": t_center, "sig": sig,
                        "label": label_lookup.get(sig, -1),
                        "base_score": base_score,
                    }
        candidates = sorted(merged.values(),
                            key=lambda x: x["base_score"], reverse=True)
        pos = [x for x in candidates if x["label"] == anchor_label]
        neg = [x for x in candidates
               if x["label"] not in (-1, anchor_label)]

        # hard_negative_ratio=0.0 must actually disable hard negatives;
        # reserve the minimum one slot only for a positive ratio.
        c_neg = int(round(c * hard_negative_ratio))
        if hard_negative_ratio > 0:
            c_neg = max(1, c_neg)
        c_neg = min(c_neg, c - 1) if c > 1 else 0
        c_pos = c - c_neg
        sel = dict(global_counts=global_counts, max_per_video=max_per_video,
                   max_global_appearances=max_global_appearances,
                   min_time_gap=min_time_gap, lambda_global=lambda_global)
        # Per-pool diversity state persists into the backfill calls so a
        # backfilled pick still honors the caps/time gaps against what
        # that pool already kept.
        pos_state = dict(video_counts={}, video_times=defaultdict(list))
        neg_state = dict(video_counts={}, video_times=defaultdict(list))
        kept_pos = greedy_select_candidates(pos, c_pos, **sel, **pos_state)
        kept_neg = greedy_select_candidates(neg, c_neg, **sel, **neg_state)

        # Backfill underfilled quotas from the other pool.
        total_kept = len(kept_pos) + len(kept_neg)
        if total_kept < c:
            used = {x["sig"] for x in kept_pos + kept_neg}
            extra_pos = greedy_select_candidates(
                [x for x in pos if x["sig"] not in used],
                c - total_kept, **sel, **pos_state)
            kept_pos += extra_pos
            used.update(x["sig"] for x in extra_pos)
            total_kept = len(kept_pos) + len(kept_neg)
            if total_kept < c:
                kept_neg += greedy_select_candidates(
                    [x for x in neg if x["sig"] not in used],
                    c - total_kept, **sel, **neg_state)

        kept = kept_pos + kept_neg
        flags = [0] * len(kept_pos) + [1] * len(kept_neg)
        if kept:
            perm = rng.permutation(len(kept))
            kept = [kept[i] for i in perm]
            flags = [flags[i] for i in perm]

        dim = kept[0]["emb"].shape[0] if kept else 768
        cache[(side, bin_id, anchor_label)] = {
            "embeddings": np.asarray([x["emb"] for x in kept],
                                     np.float32).reshape(-1, dim),
            "vid": np.asarray([x["vid"] for x in kept], np.int32),
            "side": np.asarray([side] * len(kept), dtype=object),
            "t_center": np.asarray([x["t_center"] for x in kept], np.float32),
            "label": np.asarray([x["label"] for x in kept], np.int32),
            "is_hard_negative": np.asarray(flags, np.int32),
        }
        if verbose:
            print(f"[CACHE] ({side}, {bin_id}, lbl={anchor_label}) "
                  f"raw={len(candidates)} kept={len(kept)} "
                  f"pos={len(kept_pos)} neg={len(kept_neg)}")
    return cache


def get_retrieval_cache(metadata, cache, *, top_k: int, delta_t: float = 0.1,
                        dim: int = 768):
    """Batch consumer: (retrieved (B, K, D) L2-normalized, labels (B, K),
    is_hard_negative (B, K)); same-video rows excluded, zero/-1 padding
    (reference: nba_proj/train/training_chunk_cached.py:709-777)."""
    sides = [s.decode() if isinstance(s, bytes) else str(s)
             for s in np.asarray(metadata["side"])]
    t_centers = np.asarray(metadata["t_center"], np.float64)
    vids = np.asarray(metadata["vid"], np.int64)
    labels = np.asarray(metadata["label"], np.int64)
    b = len(sides)

    retrieved = np.zeros((b, top_k, dim), np.float32)
    out_labels = np.full((b, top_k), -1, np.int32)
    out_neg = np.full((b, top_k), -1, np.int32)
    for i in range(b):
        pool = cache.get((sides[i], coarse_time_bin(t_centers[i], delta_t),
                          int(labels[i])))
        if pool is None or len(pool["vid"]) == 0:
            continue
        mask = pool["vid"] != vids[i]
        cand = pool["embeddings"][mask][:top_k]
        n = len(cand)
        if n:
            retrieved[i, :n] = cand
            out_labels[i, :n] = pool["label"][mask][:top_k]
            out_neg[i, :n] = pool["is_hard_negative"][mask][:top_k]
    norms = np.linalg.norm(retrieved, axis=2, keepdims=True)
    retrieved = retrieved / np.maximum(norms, 1e-12)
    return retrieved, out_labels, out_neg



