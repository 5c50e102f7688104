"""Synthetic tiny "videos" for tests, demos and game-length benchmarks.

Port of vit_research_tpu/data/synthetic.py, the same pixels for the same
arguments: miniature games (frame JPEGs with side-dependent statistics,
clip directories, manual intervals, clip labels and event templates), so
every stage runs end to end without real footage.
"""

from __future__ import annotations

import os

import numpy as np

from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.data import naming


def synth_frame(vid: int, fnum: int, side: str, size=(48, 64),
                rng=None) -> np.ndarray:
    """RGB uint8 frame encoding the side two ways: half-image brightness
    (spatial signal, for position-aware features) and a channel tint
    (red=left, blue=right; survives spatially-symmetric pooling)."""
    rng = rng or np.random.default_rng(vid * 100003 + fnum)
    h, w = size
    img = rng.integers(60, 120, size=(h, w, 3), dtype=np.uint8).astype(np.int32)
    half = w // 2
    if side == "left":
        img[:, :half] += 100
        img[:, :, 0] += 50
    elif side == "right":
        img[:, half:] += 100
        img[:, :, 2] += 50
    return np.minimum(img, 255).astype(np.uint8)


def write_video_frames(root: str, vid: int, segments,
                       size=(48, 64)) -> list[str]:
    """Write a raw frame dump dir like preprocess_frames.py's output.

    Args:
      segments: list of (side, num_frames); frames are numbered
        consecutively from 1 across segments.
    Returns list of written frame paths."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(vid)
    paths = []
    fnum = 1
    for side, n in segments:
        for _ in range(n):
            img = synth_frame(vid, fnum, side, size, rng)
            p = os.path.join(root, naming.frame_name(vid, fnum))
            Image.fromarray(img).save(p, quality=90)
            paths.append(p)
            fnum += 1
    return paths


def write_clips(root: str, vid: int, clips, size=(48, 64)) -> list[str]:
    """Write clip directories like generate_clips_hmm's store_clip output.

    Args:
      clips: list of (clip_num, side, first_frame, num_frames).
    Returns list of clip dir paths."""
    from PIL import Image

    clip_paths = []
    rng = np.random.default_rng(vid + 999)
    for clip_num, side, first, n in clips:
        cdir = os.path.join(root, naming.clip_dir_name(vid, clip_num, side))
        os.makedirs(cdir, exist_ok=True)
        for k in range(n):
            fnum = first + k
            img = synth_frame(vid, fnum, side, size, rng)
            Image.fromarray(img).save(
                os.path.join(cdir, naming.frame_name(vid, fnum)), quality=90)
        clip_paths.append(cdir)
    return clip_paths


def make_mini_dataset(tmpdir: str, vids=(1, 2), clips_per_vid: int = 3,
                      frames_per_clip: int = 16, size=(48, 64)):
    """Clip dirs + labels + event templates for chunk-pipeline tests.

    Returns (clip_root_template, clip_labels, event_template).

    The labels are degenerate on purpose: ``label = clip % 2 = side``, so
    make/miss is predictable from the side tint. That serves structural
    checks (shapes, metadata, plumbing); a check of a trained model's
    accuracy relabels first, or the model passes by reading the side."""
    clip_labels = {}
    event_template = {}
    for vid in vids:
        root = os.path.join(tmpdir, f"clips_hmm_smooth_{vid}_smart")
        spec = []
        for c in range(clips_per_vid):
            side = ("left", "right")[c % 2]
            spec.append((c, side, 1 + c * (frames_per_clip + 10),
                         frames_per_clip))
        clip_dirs = write_clips(root, vid, spec, size)
        for cdir, (c, side, first, n) in zip(clip_dirs, spec):
            label = c % 2  # alternate make/miss
            clip_labels[cdir] = label
            mid = first + n // 2
            key = "event_make" if label == 1 else "event_miss"
            event_template[cdir] = {
                "event_make": [], "event_miss": [], "event_none": [],
            }
            event_template[cdir][key] = [[mid, mid + 3]]
    template = os.path.join(tmpdir, "clips_hmm_smooth_{vid}_smart")
    return template, clip_labels, event_template


def make_manual_intervals(vids=(1,), segs=((("left", 30), ("none", 10),
                                            ("right", 30)),)):
    """ManualIntervals matching write_video_frames segments."""
    mi = labels_mod.ManualIntervals()
    for vid, vid_segs in zip(vids, segs):
        fnum = 1
        for side, n in vid_segs:
            mi.intervals[side].append((vid, fnum, fnum + n - 1))
            fnum += n
    return mi
