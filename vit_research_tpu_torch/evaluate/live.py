"""Live event localization: score possession clips the moment they end.

Port of vit_research_tpu/evaluate/live.py. The instant a possession
clip's padded extent is final (mid-game, in segment/pipeline.py's live
session), its frames are chunked with the offline windowing
(data/chunks.py), embedded (from the stream's cached embeddings, the
rest through ``embed_fn``), encoded by the frozen stage-1 ChunkEncoder
in one batch, run through live sim / contrast / temporal retrieval and
the stage-2 RATTHeadV2, and returned as one eval row in the offline
schema (evaluate/clip_sequences.py), so ``score-events`` reads rows made
seconds after the possession ended.

``score_clip`` is ``infer_clip_sequences`` scoped to one finished clip,
with the frame-store gather replaced by the clip's embeddings in memory.
The JAX package pads the encoder's batch to a power of two against
recompiles; the port's encoder runs any batch, so it does not.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from vit_research_tpu_torch.data.chunks import build_chunks
from vit_research_tpu_torch.evaluate.clip_sequences import \
    infer_clip_sequences
from vit_research_tpu_torch.retrieval.cache_stage2 import make_chunk_key


class LiveEventScorer:
    """Score one finished clip at a time against a retrieval collection.

    Args:
      embed_fn: frame paths -> (N, D) float32 frame embeddings, from the
        engine that built the collection.
      encode_batch: (B, T, D) -> (chunk_embs, logits), the frozen stage-1
        ChunkEncoder (train/train_chunk_encoder.py::make_encode_fn).
      head_apply: callable(query, sim, contrast, temporal) -> (B, 1)
        logits, the trained stage-2 RATTHeadV2.
      collection: the chunk collection (ratt_db schema) for live
        retrieval.
      chunk_size / chunk_stride: those of stage-1 / stage-2 training.
      proxy_label: live clips carry no make/miss label; the stage-1
        encoder's class logit estimates each chunk's label for branch
        selection only (the row still reports ``label`` -1).
      emb_cache_cap: the frame-embedding LRU's size (None: unbounded).
      self_sim_cap: candidates at cosine >= this to the query chunk are
        dropped (None: kept); live chunks cannot use coordinate
        self-exclusion, and a game already in the collection would
        return its stored twin at cosine ~1.0.
    """

    def __init__(self, embed_fn, encode_batch, head_apply, collection, *,
                 chunk_size: int = 8, chunk_stride: int = 2,
                 k_sim: int = 8, k_contrast: int = 8, k_temporal: int = 4,
                 future_step: int = 2, search_k_content: int = 64,
                 search_k_temporal: int = 32, top_k_event_chunks: int = 5,
                 batch_size: int = 16, zeros_query: bool = False,
                 proxy_label: bool = True, emb_cache_cap: int | None = None,
                 self_sim_cap: float | None = 0.9999):
        self.embed_fn = embed_fn
        self.encode_batch = encode_batch
        self.head_apply = head_apply
        self.collection = collection
        self.chunk_size = int(chunk_size)
        self.chunk_stride = int(chunk_stride)
        self.k_sim = int(k_sim)
        self.k_contrast = int(k_contrast)
        self.k_temporal = int(k_temporal)
        self.future_step = int(future_step)
        self.search_k_content = int(search_k_content)
        self.search_k_temporal = int(search_k_temporal)
        self.top_k_event_chunks = int(top_k_event_chunks)
        self.batch_size = int(batch_size)
        self.zeros_query = bool(zeros_query)
        self.proxy_label = bool(proxy_label)
        # frame basename -> (D,) embedding, least recently used first;
        # filled by ``remember`` (the stream already embedded every frame),
        # misses go to embed_fn
        self.emb_cache: OrderedDict = OrderedDict()
        self.emb_cache_cap = emb_cache_cap
        self.self_sim_cap = self_sim_cap

    def remember(self, frame_paths, embs) -> None:
        """Cache frame embeddings by basename (clip dirs hold copies of
        the source frames under the same names)."""
        embs = np.asarray(embs, np.float32)
        for p, e in zip(frame_paths, embs):
            key = os.path.basename(str(p))
            self.emb_cache[key] = e
            self.emb_cache.move_to_end(key)
        if self.emb_cache_cap is not None:
            while len(self.emb_cache) > self.emb_cache_cap:
                self.emb_cache.popitem(last=False)

    def _frame_embeddings(self, frame_paths) -> np.ndarray:
        """(N, D) embeddings of the clip's frames: cache hits by basename,
        one embed_fn call for all misses."""
        rows = [self.emb_cache.get(os.path.basename(p))
                for p in frame_paths]
        miss = [i for i, r in enumerate(rows) if r is None]
        if miss:
            fresh = np.asarray(
                self.embed_fn([frame_paths[i] for i in miss]), np.float32)
            for j, i in enumerate(miss):
                rows[i] = fresh[j]
        return np.stack([np.asarray(r, np.float32) for r in rows])

    def build_clip_chunks(self, frame_paths, *, side: str, clip_num: int,
                          vid: int) -> list[dict]:
        """A finished clip's ordered frames chunked with the offline
        windowing (``t_norm = (i + 1) / n`` is within the clip, known the
        moment it ends); ``label`` -1 and frame statuses -1, which chunk
        to status 0 as offline chunks built without a template."""
        n = len(frame_paths)
        samples = [{
            "pth": str(p), "side": str(side), "t_norm": (i + 1) / n,
            "clip_num": int(clip_num), "vid_num": int(vid),
            "label": -1, "status": "", "status_id": -1,
        } for i, p in enumerate(frame_paths)]
        return build_chunks(samples, chunk_size=self.chunk_size,
                            chunk_stride=self.chunk_stride)

    def score_clip(self, frame_paths, *, side: str, clip_num: int,
                   vid: int) -> dict | None:
        """One finished clip -> one eval row (infer_clip_sequences'
        schema); None when the clip is shorter than one chunk."""
        frame_paths = [str(p) for p in frame_paths]
        chunks = self.build_clip_chunks(frame_paths, side=side,
                                        clip_num=clip_num, vid=vid)
        if not chunks:
            return None
        embs = self._frame_embeddings(frame_paths)
        row_of = {p: i for i, p in enumerate(frame_paths)}
        # one encoder batch for the whole clip, which also gives the
        # stage-1 proxy logits
        chunk_embs, logits = self.encode_batch(np.stack(
            [embs[[row_of[p] for p in ch["frames"]]] for ch in chunks]))
        chunk_embs = np.asarray(chunk_embs, np.float32)
        chunk_embs = chunk_embs / (np.linalg.norm(chunk_embs, axis=-1,
                                                  keepdims=True) + 1e-8)
        if self.proxy_label and logits is not None:
            for ch, lg in zip(chunks, np.asarray(logits).reshape(-1)):
                ch["retrieval_label"] = int(lg > 0)
        encoded = {make_chunk_key(ch): e
                   for ch, e in zip(chunks, chunk_embs)}
        rows = infer_clip_sequences(
            chunks, self.head_apply, lambda ch: encoded[make_chunk_key(ch)],
            self.collection, k_sim=self.k_sim, k_contrast=self.k_contrast,
            k_temporal=self.k_temporal, future_step=self.future_step,
            search_k_content=self.search_k_content,
            search_k_temporal=self.search_k_temporal,
            batch_size=self.batch_size, zeros_query=self.zeros_query,
            top_k_event_chunks=self.top_k_event_chunks,
            # a live clip is in no store: its session-local coordinates
            # can collide with unrelated rows, so the embedding cap stands
            # in for coordinate self-exclusion
            exclude_self=False, self_sim_cap=self.self_sim_cap)
        return rows[0] if rows else None
