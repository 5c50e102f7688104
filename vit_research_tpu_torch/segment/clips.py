"""Clip interval extraction, clip-directory writing, finalize and merge.

Port of vit_research_tpu/segment/clips.py (that module cannot be imported
without JAX: it imports segment.hmm, which imports ops.viterbi):

- streaks of side labels of at least ``min_len`` frames, padded by
  ``pad`` (clamped to the sequence), written as ``vid{N}_clip_{K}_{side}``
  directories (nba_proj/generate_clips_hmm.py:68-86,135-177);
  :class:`StreamingClipExtractor` emits the same intervals online, for
  the live path;
- per-clip finalize: a fresh HMM decode of each clip's per-frame vote
  probabilities, keeping the frames whose state is the clip's side
  (nba_proj/finalize_clips.py:24,134-192);
- merge of adjacent same-side clips that overlap or lie within
  ``max_gap`` frames, per video (nba_proj/merge_clips.py:17-113).
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

import numpy as np

from vit_research_tpu_torch.data import naming
from vit_research_tpu_torch.segment.hmm import STATES, smooth_probabilities


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


class StreamingClipExtractor:
    """Online counterpart of :func:`clip_intervals_from_decoded`: feed
    decoded states one at a time and qualifying side streaks are emitted
    as padded :class:`ClipInterval`\\ s as soon as their extent is final
    (``pad`` frames past the streak's last frame) instead of after the
    whole game. ``finish()`` flushes streaks running into the end of the
    stream, clamping exactly like the offline extractor, so pushing an
    offline decode through this class reproduces
    ``clip_intervals_from_decoded`` verbatim.

    Composes with segment/hmm.py::StreamingViterbi for live
    segmentation (segment/pipeline.py::KnnHmmStreamSession).
    """

    def __init__(self, *, min_len: int = 100, pad: int = 100,
                 sides=("left", "right")):
        self.min_len = int(min_len)
        self.pad = int(pad)
        self.sides = tuple(sides)
        self._i = 0                 # states consumed so far
        self._run_state: str | None = None
        self._run_start = 0
        self._pending: list[ClipInterval] = []  # ends not yet final

    def push(self, state) -> list[ClipInterval]:
        """Feed one decoded state (int index or side string); returns
        the clips whose padded extent became final with this frame."""
        label = (STATES[state] if isinstance(state, (int, np.integer))
                 else str(state))
        if label != self._run_state:
            if self._run_state is not None:
                self._queue_run(end=self._i - 1)
            self._run_state = label
            self._run_start = self._i
        self._i += 1
        return self._flush(last=self._i - 1)

    def finish(self) -> list[ClipInterval]:
        """Flush: close the running streak and finalize every pending
        clip with the end clamped to the last frame seen."""
        if self._run_state is not None:
            self._queue_run(end=self._i - 1)
            self._run_state = None
        last = self._i - 1
        out = [ClipInterval(c.side, c.start, min(c.end, last))
               for c in self._pending]
        self._pending.clear()
        return out

    def _queue_run(self, end: int) -> None:
        if (self._run_state in self.sides
                and end - self._run_start + 1 >= self.min_len):
            self._pending.append(ClipInterval(
                self._run_state, max(0, self._run_start - self.pad),
                end + self.pad))

    def _flush(self, last: int) -> list[ClipInterval]:
        out = []
        while self._pending and self._pending[0].end <= last:
            out.append(self._pending.pop(0))
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


def finalize_clip(frame_labels_probs, clip_side, *, device,
                  transition_matrix=None):
    """Per-clip refinement: HMM-smooth the per-frame vote probabilities and
    keep only frames whose decoded state matches the clip label.

    Args:
      frame_labels_probs: (T, 3) per-frame probabilities (e.g. 5-NN votes).
      clip_side: 'left' | 'right' | 'none'.
      device: where a clip of 8192 frames or more is decoded (shorter
        clips decode on the host, as in the reference's routing).
    Returns boolean keep mask (T,)."""
    path = smooth_probabilities(frame_labels_probs,
                                transition_matrix=transition_matrix,
                                device=device)
    return np.asarray(path) == STATES.index(clip_side)


def finalize_clip_dirs(clip_dirs, frame_probs_fn, out_root: str, *, device,
                       copy: bool = True) -> list[str]:
    """Apply :func:`finalize_clip` to clip directories
    (reference: nba_proj/finalize_clips.py:134-192).

    Args:
      frame_probs_fn: callable(list of frame paths) -> (T, 3) probabilities
        (typically embed + 5-NN vote).
    An existing destination is skipped before any embedding work, so
    re-runs are free (the reference's idempotent skip)."""
    os.makedirs(out_root, exist_ok=True)
    out_dirs = []
    for cdir in clip_dirs:
        name = os.path.basename(cdir)
        dest = os.path.join(out_root, name)
        if os.path.exists(dest):
            out_dirs.append(dest)
            continue
        _, _, side = naming.parse_clip_dir(name)
        frames = sorted(os.listdir(cdir), key=naming.frame_sort_key)
        if not frames:
            continue
        probs = frame_probs_fn([os.path.join(cdir, f) for f in frames])
        keep = finalize_clip(probs, side, device=device)
        os.makedirs(dest, exist_ok=True)
        if copy:
            for f, k in zip(frames, keep):
                if k:
                    shutil.copy(os.path.join(cdir, f), os.path.join(dest, f))
        out_dirs.append(dest)
    return out_dirs


def merge_clip_ranges(clips, *, max_gap: int = 30):
    """Merge adjacent same-side clips whose frame ranges overlap or whose
    gap is <= max_gap (reference: nba_proj/merge_clips.py:17-113).

    Args:
      clips: list of (side, start_frame, end_frame), in any order.
    Returns the merged list of (side, start_frame, end_frame)."""
    if not clips:
        return []
    clips = sorted(clips, key=lambda c: (c[1], c[2]))
    merged = [list(clips[0])]
    for side, s, e in clips[1:]:
        last = merged[-1]
        if side == last[0] and s <= last[2] + max_gap:
            last[2] = max(last[2], e)
        else:
            merged.append([side, s, e])
    return [tuple(c) for c in merged]


def merge_clip_dirs(clip_dirs, frame_pool_dir: str, out_root: str,
                    *, max_gap: int = 30, copy: bool = True,
                    drop_none: bool = True) -> list[str]:
    """Directory-level merge: read clip ranges from the directories' frame
    names, merge them per video (frame numbers of different videos never
    fuse), and rebuild the merged directories from the full frame pool.
    ``drop_none`` leaves none-side clips out of the output, as the
    reference does (nba_proj/merge_clips.py:53-55)."""
    by_vid: dict = {}
    for cdir in clip_dirs:
        v, _, side = naming.parse_clip_dir(os.path.basename(cdir))
        if drop_none and side == "none":
            continue
        frames = sorted(os.listdir(cdir), key=naming.frame_sort_key)
        if not frames:
            continue
        by_vid.setdefault(v, []).append(
            (side, naming.frame_num(frames[0]),
             naming.frame_num(frames[-1])))
    os.makedirs(out_root, exist_ok=True)
    out = []
    for vid in sorted(by_vid):
        merged = merge_clip_ranges(by_vid[vid], max_gap=max_gap)
        for k, (side, s, e) in enumerate(merged, start=1):
            cdir = os.path.join(out_root, naming.clip_dir_name(vid, k, side))
            os.makedirs(cdir, exist_ok=True)
            if copy:
                for num in range(s, e + 1):
                    f = naming.frame_name(vid, num)
                    src = os.path.join(frame_pool_dir, f)
                    if os.path.exists(src):
                        shutil.copy(src, os.path.join(cdir, f))
            out.append(cdir)
    return out
