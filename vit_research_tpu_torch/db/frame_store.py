"""Memmap frame-embedding store + chunk index arrays.

Port of vit_research_tpu/db/frame_store.py, unchanged, so either package
opens a store the other built. Equivalent of the reference's canonical
store builder (reference: nba_proj/db_maintainence/build_embeddings_store.py): a
``np.memmap (N, D)`` of frame embeddings with a parallel paths array and
meta sidecar (:149-198), chunk index arrays + chunk metadata (:240-302),
and fancy-index gather of (B, T, D) chunk batches (:325-331). Training
stage 1 reads exclusively from this store — no image decode in the loop
(reference: nba_proj/train/train_chunk_encoder.py:218-244).
"""

from __future__ import annotations

import json
import os

import numpy as np


class FrameStore:
    """Single-writer memmap of frame embeddings keyed by frame path."""

    def __init__(self, directory: str):
        self.dir = directory
        self.embedding_profile = None  # set by open()/build()
        self._mm = None
        self._paths = None
        self._path_to_idx = None

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, frame_paths, embed_fn, directory: str, *,
              batch_size: int = 1024, dim: int | None = None,
              verbose: bool = False, embedding_profile: str | None = None) -> "FrameStore":
        """Embed unique frame paths and write the store.

        Args:
          embed_fn: callable(list_of_paths) -> (n, D) float32 (typically
            EmbeddingEngine.embed_paths — batched, data-parallel).
        """
        unique = list(dict.fromkeys(frame_paths))  # order-preserving dedup
        if not unique:
            # Writing paths.npy/meta.json with n=0 but no embeddings.dat
            # would leave a permanently unopenable store directory.
            raise ValueError(
                "FrameStore.build: no frame paths (did the clip filters "
                "drop everything?)")
        os.makedirs(directory, exist_ok=True)
        n = len(unique)
        mm = None
        for start in range(0, n, batch_size):
            chunk = unique[start:start + batch_size]
            embs = np.asarray(embed_fn(chunk), np.float32)
            if mm is None:
                dim = embs.shape[1] if dim is None else dim
                mm = np.memmap(os.path.join(directory, "embeddings.dat"),
                               dtype=np.float32, mode="w+", shape=(n, dim))
            mm[start:start + len(chunk)] = embs
            if verbose:
                print(f"frame_store: {start + len(chunk)}/{n}")
        if mm is not None:
            mm.flush()
        np.save(os.path.join(directory, "paths.npy"),
                np.asarray(unique, dtype=str))
        with open(os.path.join(directory, "meta.json"), "w") as f:
            # embedding_profile: which engine settings produced these
            # rows (cli/common.engine_profile) — collections derived
            # from this store inherit it, so cross-profile queries can
            # warn (see vector_store.Collection.stamp_embedding_profile)
            json.dump({"n": n, "dim": int(dim or 0),
                       "embedding_profile": embedding_profile}, f)
        store = cls(directory)
        store.open()
        return store

    def open(self) -> "FrameStore":
        with open(os.path.join(self.dir, "meta.json")) as f:
            meta = json.load(f)
        self.n = meta["n"]
        self.dim = meta["dim"]
        self.embedding_profile = meta.get("embedding_profile")
        self._mm = np.memmap(os.path.join(self.dir, "embeddings.dat"),
                             dtype=np.float32, mode="r",
                             shape=(self.n, self.dim))
        self._paths = np.load(os.path.join(self.dir, "paths.npy"))
        self._path_to_idx = {p: i for i, p in enumerate(self._paths)}
        return self

    # ------------------------------------------------------------- reads

    @property
    def paths(self):
        return self._paths

    def index_of(self, path: str) -> int:
        return self._path_to_idx[path]

    def covers(self, frame_paths) -> bool:
        """Coverage check (reference:
        nba_proj/ratt_write_clips_to_ragdb.py:338-352)."""
        if self._path_to_idx is None:
            self.open()
        return all(p in self._path_to_idx for p in frame_paths)

    def gather(self, indices) -> np.ndarray:
        """Fancy-index gather: (B, T) int -> (B, T, D)."""
        idx = np.asarray(indices)
        return np.asarray(self._mm[idx.reshape(-1)]).reshape(
            *idx.shape, self.dim)

    def gather_paths(self, path_lists) -> np.ndarray:
        idx = np.asarray([[self._path_to_idx[p] for p in row]
                          for row in path_lists])
        return self.gather(idx)


def build_chunk_index(chunk_samples, store: FrameStore, directory: str):
    """Chunk index arrays + metadata npz
    (reference: nba_proj/db_maintainence/build_embeddings_store.py:240-302).

    Writes chunk_index.npz with:
      frame_idx (C, T) int32 — rows into the frame store,
      label, status_id, vid, clip, start_idx, end_idx (C,) ints,
      t_center, t_width (C,) float32, side (C,) unicode.
    """
    os.makedirs(directory, exist_ok=True)
    c = len(chunk_samples)
    t = len(chunk_samples[0]["frames"]) if c else 0
    frame_idx = np.zeros((c, t), np.int32)
    for i, ch in enumerate(chunk_samples):
        if len(ch["frames"]) != t:
            raise ValueError("inconsistent chunk size "
                             f"{len(ch['frames'])} != {t}")
        frame_idx[i] = [store.index_of(p) for p in ch["frames"]]
    arrays = {
        "frame_idx": frame_idx,
        "label": np.asarray([ch["label"] for ch in chunk_samples], np.int32),
        "status_id": np.asarray([ch["status_id"] for ch in chunk_samples],
                                np.int32),
        "vid": np.asarray([ch["vid"] for ch in chunk_samples], np.int32),
        "clip": np.asarray([ch["clip"] for ch in chunk_samples], np.int32),
        "start_idx": np.asarray([ch["start_idx"] for ch in chunk_samples],
                                np.int32),
        "end_idx": np.asarray([ch["end_idx"] for ch in chunk_samples],
                              np.int32),
        "t_center": np.asarray([ch["t_center"] for ch in chunk_samples],
                               np.float32),
        "t_width": np.asarray([ch["t_width"] for ch in chunk_samples],
                              np.float32),
        "side": np.asarray([ch["side"] for ch in chunk_samples], dtype=str),
    }
    np.savez(os.path.join(directory, "chunk_index.npz"), **arrays)
    return arrays


def load_chunk_index(directory: str) -> dict:
    data = np.load(os.path.join(directory, "chunk_index.npz"))
    return {k: data[k] for k in data.files}


def gather_chunk_embedding_batch(store: FrameStore, chunk_index,
                                 chunk_ids) -> np.ndarray:
    """(B,) chunk ids -> (B, T, D)
    (reference: build_embeddings_store.py:325-331)."""
    return store.gather(chunk_index["frame_idx"][np.asarray(chunk_ids)])
