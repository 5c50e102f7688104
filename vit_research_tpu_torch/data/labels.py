"""Label sources: manual side intervals, clip labels, frame-event intervals.

Port of the readers of vit_research_tpu/data/labels.py that the port's
verbs use (write-frame-db, build-frame-store):
1. ``manual_intervals.csv`` — columns ``{left,right,none}_{start,end}``
   holding ``vid{N}_{frame}`` tokens; rows may be ragged/NaN
   (reference: nba_proj/write_per_video_embeddings.py:15-56).
2. ``clips_label.csv`` — columns ``clip_path,label`` with label in
   {0,1} or empty => -1 = unlabeled / inference-only
   (reference: nba_proj/dataset.py:76-78,96-106).
3. ``clip_labelling_template.json`` — per-clip-path dict with
   ``event_make`` / ``event_miss`` / ``event_none`` lists of
   [start_frame, end_frame] inclusive ranges
   (reference: nba_proj/dataset.py:77-78,118-141).
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field

from vit_research_tpu_torch.data import naming

SIDES = ("left", "right", "none")

# Frame-event status ids and the reference's exact status strings —
# note 'event-made', not 'event-make' (the JSON template KEY is
# event_make but the emitted string is 'event-made';
# reference: nba_proj/dataset.py:118-141).
EVENT_NONE, EVENT_MISS, EVENT_MAKE = 0, 1, 2
EVENT_NAMES = {EVENT_NONE: "event-none", EVENT_MISS: "event-miss",
               EVENT_MAKE: "event-made"}


@dataclass
class ManualIntervals:
    """Side-labeled frame intervals, inclusive on both ends."""

    # side -> list of (vid, start_frame, end_frame)
    intervals: dict = field(default_factory=lambda: {s: [] for s in SIDES})
    # optional per-vid ignore ranges (vid, start, end)
    ignore: list = field(default_factory=list)

    @staticmethod
    def _parse_token(token: str) -> tuple[int, int]:
        vid_str, num = token.rsplit("_", 1)
        return int(vid_str[3:]), int(num)

    @classmethod
    def from_csv(cls, path: str) -> "ManualIntervals":
        out = cls()
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                for side in SIDES:
                    start = (row.get(f"{side}_start") or "").strip()
                    end = (row.get(f"{side}_end") or "").strip()
                    if (not start or not end
                            or "_" not in start or "_" not in end):
                        continue
                    vid, s = cls._parse_token(start)
                    _, e = cls._parse_token(end)
                    out.intervals[side].append((vid, s, e))
        return out

    def class_from_frame(self, frame: str) -> str:
        """Side label for a frame filename; 'ignore' when unlabeled
        (priority order left -> right -> none, inclusive ranges)."""
        vid, num = naming.parse_frame_name(frame)
        for ivid, s, e in self.ignore:
            if vid == ivid and s <= num <= e:
                return "ignore"
        for side in SIDES:
            for ivid, s, e in self.intervals[side]:
                if vid == ivid and s <= num <= e:
                    return side
        return "ignore"


def load_clip_labels(path: str) -> dict:
    """clip_path -> int label; missing/NaN => -1 (inference-only)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            raw = (row.get("label") or "").strip()
            try:
                label = int(float(raw)) if raw else -1
            except ValueError:
                label = -1
            out[row["clip_path"]] = label
    return out


def load_event_template(path: str) -> dict:
    """clip_path -> {'event_make': [[s,e],...], 'event_miss': ...,
    'event_none': ...}."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def frame_event_status(fnum: int, events: dict) -> tuple[str, int]:
    """Status for one frame from a clip's event dict. Later categories win
    on overlap, mirroring the reference's sequential overwrites
    (make -> miss -> none, reference: nba_proj/dataset.py:126-141)."""
    status, status_id = "", -1
    for key, sid in (("event_make", EVENT_MAKE), ("event_miss", EVENT_MISS),
                     ("event_none", EVENT_NONE)):
        for rng in events.get(key, ()):
            if rng[0] <= fnum <= rng[1]:
                status, status_id = EVENT_NAMES[sid], sid
    return status, status_id
