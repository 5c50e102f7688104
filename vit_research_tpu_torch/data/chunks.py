"""Sliding-window chunking of clips, and class oversampling.

Port of ``build_chunks`` / ``chunk_event_label`` from
vit_research_tpu/data/chunks.py (reference: nba_proj/dataset.py:166-260)
with identical windowing arithmetic (size/stride, ``t_center``,
``t_width``, ``start_idx``/``end_idx``) so chunk boundaries match
frame-for-frame, and of ``oversample_chunk_samples``
(nba_proj/dataset.py:26-73) with the JAX package's seeded numpy draws.
"""

from __future__ import annotations

import numpy as np

# The reference's status strings are INCONSISTENT between levels:
# per-frame samples say 'event-made' (nba_proj/dataset.py:130) but
# chunk dicts say 'event-make' (event_lookups, nba_proj/dataset.py:184-188,
# :249). Both are mirrored exactly; consumers key on status_id.
CHUNK_EVENT_NAMES = {0: "event-none", 1: "event-miss", 2: "event-make"}


def chunk_event_label(frame_event_labels, event_threshold: int = 3) -> int:
    """Chunk-level event from frame statuses
    (reference rule: nba_proj/dataset.py:166-182):
    make wins if >= threshold and >= miss count; else miss if >= threshold
    and > make count; else none."""
    make_count = sum(int(x == 2) for x in frame_event_labels)
    miss_count = sum(int(x == 1) for x in frame_event_labels)
    if make_count >= event_threshold and make_count >= miss_count:
        return 2
    if miss_count >= event_threshold and miss_count > make_count:
        return 1
    return 0


def build_chunks(frame_samples, chunk_size: int = 12, chunk_stride: int = 4,
                 event_threshold: int = 3) -> list[dict]:
    """Overlapping windows per (vid, clip); clips shorter than chunk_size
    are skipped (reference: nba_proj/dataset.py:189-260)."""
    if chunk_stride <= 0 or chunk_size <= 0:
        raise ValueError("chunk_size and chunk_stride must be positive")

    clips: dict = {}
    for s in frame_samples:
        clips.setdefault((s["vid_num"], s["clip_num"]), []).append(s)
    for key in clips:
        clips[key].sort(key=lambda x: x["t_norm"])

    chunk_samples = []
    for (vid, clip), frames in sorted(clips.items()):
        total = len(frames)
        if total < chunk_size:
            continue
        label = frames[0]["label"]
        side = frames[0]["side"]
        for start in range(0, total - chunk_size + 1, chunk_stride):
            end = start + chunk_size
            sub = frames[start:end]
            stat_ids = [f["status_id"] for f in sub]
            t_vals = [f["t_norm"] for f in sub]
            sid = chunk_event_label(stat_ids, event_threshold)
            chunk_samples.append({
                "frames": [f["pth"] for f in sub],
                "label": label,
                "status": CHUNK_EVENT_NAMES[sid],
                "status_id": sid,
                "side": side,
                "vid": vid,
                "clip": clip,
                "t_center": float(sum(t_vals) / len(t_vals)),
                "t_width": float(max(t_vals) - min(t_vals)),
                "start_idx": start,
                "end_idx": end - 1,
            })
    return chunk_samples


def oversample_chunk_samples(chunk_samples, target="max", seed: int = 1234):
    """Oversample by status_id to balance the event classes
    (nba_proj/dataset.py:26-73). ``target='max'`` lifts every class to the
    largest class's count; a number lifts to target * count(class 0).
    The draws are ``np.random.default_rng(seed)``'s, in the JAX package's
    order, so the list equals its list for list."""
    rng = np.random.default_rng(seed)
    by_class: dict = {0: [], 1: [], 2: []}
    for c in chunk_samples:
        by_class[int(c["status_id"])].append(c)
    counts = {k: len(v) for k, v in by_class.items()}

    if target == "max":
        target_count = max(counts.values()) if counts else 0
    else:
        target_count = int(float(target) * counts[0])

    out = []
    for items in by_class.values():
        if not items:
            continue
        if len(items) >= target_count:
            out.extend(items)
        else:
            extra = rng.choice(len(items), size=target_count - len(items),
                               replace=True)
            out.extend(items + [items[i] for i in extra])
    rng.shuffle(out)
    return out
