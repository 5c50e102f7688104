"""Qualitative side-classification dumps for unseen frames.

Port of vit_research_tpu/evaluate/fresh_test.py (reference:
nba_proj/fresh_test.py:64-101, fresh_test_per_vid.py): embed unseen
frames, classify them with the trained side classifier, and copy each
frame into a ``left/`` ``right/`` ``none/`` directory for eyeballing.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

SIDES = ("left", "right", "none")


def dump_classified_frames(frame_paths, embed_fn, classify_fn,
                           out_root: str, *, copy: bool = True) -> dict:
    """Returns {side: [frame paths]} and writes side directories."""
    embs = np.asarray(embed_fn(list(frame_paths)))
    preds = np.asarray(classify_fn(embs)).reshape(-1)
    buckets: dict = {s: [] for s in SIDES}
    for side in SIDES:
        os.makedirs(os.path.join(out_root, side), exist_ok=True)
    for path, pred in zip(frame_paths, preds):
        side = SIDES[int(pred)]
        buckets[side].append(path)
        if copy:
            shutil.copy(path, os.path.join(out_root, side,
                                           os.path.basename(path)))
    return buckets
