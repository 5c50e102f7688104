"""Chunk dataset: fixed-shape (frames, metadata, label) batches with
host-side prefetch.

Port of vit_research_tpu/data/pipeline.py (the reference's
``build_tf_dataset_chunks``, nba_proj/dataset.py:427-469): chunk dicts
-> decode + resize per frame -> the seeded numpy shuffle of
train/common.py::batch_iterator (the JAX package's batch order) -> fixed
batches (drop_remainder) -> prefetch. Decoding runs on a thread pool and
the next batch decodes while the caller consumes this one (double
buffering). Batches stay uint8: normalisation belongs to the device
(ops/patch_embed.py's kernel folds it into the projection).
"""

from __future__ import annotations

import concurrent.futures as _fut

import numpy as np

from vit_research_tpu_torch.data.preprocess import PreprocessSpec, load_frames
from vit_research_tpu_torch.train.common import (batch_iterator,
                                                 chunk_metadata_batch)


def load_chunk_frames(batch_chunks, spec: PreprocessSpec,
                      num_workers: int = 8) -> np.ndarray:
    """Chunk dicts -> (B, T, H, W, 3) uint8."""
    t = len(batch_chunks[0]["frames"])
    flat = [p for ch in batch_chunks for p in ch["frames"]]
    frames = load_frames(flat, spec, num_workers=num_workers)
    return frames.reshape(len(batch_chunks), t, *frames.shape[1:])


def chunk_dataset(chunk_samples, spec: PreprocessSpec, *, batch_size: int,
                  shuffle: bool = True, seed: int = 0,
                  drop_remainder: bool = True, num_workers: int = 8,
                  prefetch: bool = True):
    """Yields (frames (B, T, H, W, 3) uint8, metadata dict, labels (B,)
    float32)."""
    def make(batch):
        md = chunk_metadata_batch(batch)
        frames = load_chunk_frames(batch, spec, num_workers)
        return frames, md, md["label"].astype(np.float32)

    batches = batch_iterator(chunk_samples, batch_size, shuffle=shuffle,
                             seed=seed, drop_remainder=drop_remainder)
    if not prefetch:
        for b in batches:
            yield make(b)
        return
    # double buffering: batch i + 1 decodes while batch i is consumed
    with _fut.ThreadPoolExecutor(1) as pool:
        pending = None
        for b in batches:
            fut = pool.submit(make, b)
            if pending is not None:
                yield pending.result()
            pending = fut
        if pending is not None:
            yield pending.result()
