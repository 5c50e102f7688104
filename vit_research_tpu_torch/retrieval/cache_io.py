"""Atomic pickle IO for the retrieval caches.

Port of vit_research_tpu/retrieval/cache_io.py, the same format: a cache
pickled by either package loads in the other. A save writes a temporary
file and ``os.replace``s it, so a crash mid-save (during
build_stage2_cache's periodic checkpoints) never leaves a truncated cache
behind for the next resume.
"""

from __future__ import annotations

import os
import pickle


def save_cache(cache: dict, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(cache, f)
    os.replace(tmp, path)


def load_cache(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
