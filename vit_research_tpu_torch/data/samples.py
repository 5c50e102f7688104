"""Per-frame sample records from clip directories + label artifacts.

Port of vit_research_tpu/data/samples.py, unchanged. Equivalent of the
reference's ``load_samples`` (reference: nba_proj/dataset.py:75-164):
walk per-video clip folders,
join clip-level make/miss labels from ``clips_label.csv`` (-1 = unlabeled
=> inference-only) and frame-level event intervals from
``clip_labelling_template.json``, and emit one dict per frame with
``side``, ``t_norm``, ``clip_num``, ``vid_num``, ``label``, ``status``,
``status_id``. Differences: the clip root is a configurable template
instead of a hardcoded absolute path (reference: nba_proj/dataset.py:90).
"""

from __future__ import annotations

import os

from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.data import naming


def load_samples(
    vids,
    clip_root_template: str,
    clip_labels: dict | None = None,
    event_template: dict | None = None,
    *,
    stride: int = 1,
    start_clip: int = 0,
    end_clip: int = 30,
) -> list[dict]:
    """One record per (strided) frame of every selected clip.

    Args:
      vids: video numbers to include.
      clip_root_template: e.g. '/data/clips_hmm_smooth_{vid}_smart'.
      clip_labels: clip_path -> label (see labels.load_clip_labels).
      event_template: clip_path -> event dict (see labels.load_event_template).
      stride: keep every stride-th frame.
      start_clip/end_clip: clip-index window per video.
    """
    clip_labels = clip_labels or {}
    event_template = event_template or {}
    samples: list[dict] = []

    for vid in vids:
        clip_root = clip_root_template.format(vid=vid)
        if not os.path.isdir(clip_root):
            continue
        entries = []
        for name in os.listdir(clip_root):
            if not os.path.isdir(os.path.join(clip_root, name)):
                continue  # sidecar files (e.g. cached weights) are not clips
            try:
                naming.parse_clip_dir(name)
            except (ValueError, IndexError):
                continue
            entries.append(name)
        clips = sorted(entries, key=naming.clip_sort_key)
        clips = clips[start_clip:end_clip]
        for clip in clips:
            clip_path = os.path.join(clip_root, clip)
            frames = naming.list_frames(clip_path)
            clip_vid, clip_num, side = naming.parse_clip_dir(clip)
            label = clip_labels.get(clip_path, -1)
            events = event_template.get(clip_path, {})
            num_frames = len(frames)
            stride_counter = 0
            for i, fname in enumerate(frames, start=1):
                stride_counter += 1
                if stride_counter != stride:
                    continue
                stride_counter = 0
                fnum = naming.frame_num(fname)
                status, status_id = labels_mod.frame_event_status(fnum, events)
                samples.append({
                    "pth": os.path.join(clip_path, fname),
                    "side": side,
                    "t_norm": i / num_frames,
                    "clip_num": clip_num,
                    "vid_num": clip_vid,
                    "label": label,
                    "status": status,
                    "status_id": status_id,
                })
    return samples
