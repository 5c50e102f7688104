"""Clip interval extraction and clip-directory writing.

The numpy/os code of vit_research_tpu/segment/clips.py that the kNN+HMM
paths run, carried over because that module cannot be imported without
JAX (it imports segment.hmm, which imports ops.viterbi). Streaks of side
labels of at least ``min_len`` frames are padded by ``pad`` (clamped to
the sequence) and written as ``vid{N}_clip_{K}_{side}`` directories;
:class:`StreamingClipExtractor` emits the same intervals online, for the
live path.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

import numpy as np

from vit_research_tpu_torch.data import naming
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
