"""Clip interval extraction and clip-directory writing.

The numpy/os code of vit_research_tpu/segment/clips.py that the kNN+HMM
path runs, carried over because that module cannot be imported without
JAX (it imports segment.hmm, which imports ops.viterbi). Streaks of side
labels of at least ``min_len`` frames are padded by ``pad`` (clamped to
the sequence) and written as ``vid{N}_clip_{K}_{side}`` directories.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

import numpy as np

from vit_research_tpu.data import naming
from vit_research_tpu_torch.segment.hmm import STATES


@dataclass(frozen=True)
class ClipInterval:
    side: str
    start: int  # index into the decoded sequence
    end: int    # inclusive


def decoded_runs(decoded) -> list[ClipInterval]:
    """Maximal constant runs of a decoded label sequence."""
    runs = []
    n = len(decoded)
    i = 0
    while i < n:
        cur = decoded[i]
        start = i
        while i < n and decoded[i] == cur:
            i += 1
        runs.append(ClipInterval(str(cur), start, i - 1))
    return runs


def clip_intervals_from_decoded(decoded, *, min_len: int = 100,
                                pad: int = 100,
                                sides=("left", "right")) -> list[ClipInterval]:
    """Streaks of side labels at least ``min_len`` long, padded by ``pad``
    (clamped to the sequence)."""
    n = len(decoded)
    out = []
    for run in decoded_runs(decoded):
        if run.side not in sides:
            continue
        if run.end - run.start + 1 < min_len:
            continue
        out.append(ClipInterval(
            run.side, max(0, run.start - pad), min(n - 1, run.end + pad)))
    return out


def save_clips_from_sequence(decoded, frame_names, src_dir, out_root,
                             *, min_len: int = 100, pad: int = 100,
                             vid: int | None = None,
                             copy: bool = True) -> list[str]:
    """Write clip directories for qualifying streaks; returns their paths.
    ``decoded`` holds int states or side strings aligned with
    ``frame_names``."""
    labels = [STATES[d] if isinstance(d, (int, np.integer)) else str(d)
              for d in decoded]
    os.makedirs(out_root, exist_ok=True)
    clip_paths = []
    for clip_id, iv in enumerate(
            clip_intervals_from_decoded(labels, min_len=min_len, pad=pad),
            start=1):
        frames = frame_names[iv.start: iv.end + 1]
        v = vid if vid is not None else naming.vid_num(frames[0])
        cdir = os.path.join(out_root, naming.clip_dir_name(v, clip_id, iv.side))
        os.makedirs(cdir, exist_ok=True)
        if copy:
            for f in frames:
                src = os.path.join(src_dir, f)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(cdir, f))
        clip_paths.append(cdir)
    return clip_paths
