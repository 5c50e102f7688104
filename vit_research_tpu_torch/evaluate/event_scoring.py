"""Event-localization scoring: hit@k and centre error of the eval rows'
top-k chunks against the labelled events.

Port of vit_research_tpu/evaluate/event_scoring.py:

- **hit@k**: the share of event-bearing clips where one of the top-k
  chunks overlaps a labelled event interval;
- **centre error**: |top-1 chunk centre - nearest event centre| in frames
  (mean and median over the scored clips);
- a per-side breakdown and the skipped clips counted (no labelled events,
  no frame numbers);
- ``min_event_span``, the shortest labelled event, for ``segment
  --event-template``'s strided-embedding check.

Two ground truths: the event template (frame intervals per clip dir,
``truth_events_by_clip``) matched against the chunks' frame spans, or the
chunks' own ``status_id`` in the rows. Both use the reference's
make/miss-minus-none semantics (later categories overwrite earlier ones:
make -> miss -> none, data/labels.py::frame_event_status).
"""

from __future__ import annotations

import os

import numpy as np

from vit_research_tpu_torch.data import naming

# status ids (data/labels.py): 1 = event-miss, 2 = event-make
EVENT_STATUS_IDS = (1, 2)


def _subtract_spans(spans, holes):
    """Remove inclusive-interval ``holes`` from inclusive ``spans``."""
    for hs, he in holes:
        nxt = []
        for s, e in spans:
            if he < s or hs > e:     # no overlap
                nxt.append((s, e))
                continue
            if s < hs:
                nxt.append((s, hs - 1))
            if he < e:
                nxt.append((he + 1, e))
        spans = nxt
    return spans


def _event_spans(events: dict, keys) -> list:
    """One clip's event spans under ``keys``, with ``event_none``
    overwrites subtracted (unless none itself is requested)."""
    spans = [(int(s), int(e)) for key in keys
             for s, e in (events or {}).get(key, ())]
    if "event_none" not in keys:
        spans = _subtract_spans(
            spans, [(int(s), int(e)) for s, e
                    in (events or {}).get("event_none", ())])
    return spans


def min_event_span(event_template: dict,
                   keys=("event_make", "event_miss")) -> int | None:
    """Shortest labelled event span in frames (inclusive), after
    subtracting ``event_none`` overwrites, or None when the template holds
    no event intervals. The strided-embedding rule needs it: choose
    ``--frame-stride`` <= the shortest event to localize, since an event
    strictly inside one stride gap touches no keyframe
    (parallel/embed.py::embed_video_strided)."""
    spans_all = [span for events in (event_template or {}).values()
                 for span in _event_spans(events, keys)]
    if not spans_all:
        return None
    return min(e - s + 1 for s, e in spans_all)


def truth_events_by_clip(event_template: dict,
                         keys=("event_make", "event_miss")) -> dict:
    """``{(vid, clip): [(start_frame, end_frame), ...]}`` of a loaded event
    template (data/labels.py::load_event_template), whose keys are clip
    paths ending in a ``vid{N}_clip{K}_{side}`` directory name. Frames an
    ``event_none`` range covers are not events."""
    out: dict = {}
    for clip_path, events in (event_template or {}).items():
        name = os.path.basename(os.path.normpath(str(clip_path)))
        try:
            vid, clip, _side = naming.parse_clip_dir(name)
        except (ValueError, IndexError):
            raise ValueError(
                f"event template key {clip_path!r} does not end in a "
                "vid{N}_clip{K}_{side} directory name")
        spans = _event_spans(events, keys)
        if spans:
            out.setdefault((vid, clip), []).extend(spans)
    return out


def _overlaps(sf, ef, spans) -> bool:
    return any(sf <= e and s <= ef for s, e in spans)


def _center_error(chunk, spans):
    c = chunk.get("center_frame")
    if c is None:
        sf, ef = chunk.get("start_frame"), chunk.get("end_frame")
        if sf is None or ef is None:
            return None
        c = (sf + ef) // 2
    return min(abs(c - (s + e) / 2.0) for s, e in spans)


def score_event_localization(rows, truth: dict | None = None, *,
                             ks=(1, 3, 5)) -> dict:
    """Score eval rows (evaluate/clip_sequences.py's schema, or the same
    read back from JSON) with their ``topk_chunks``.

    ``truth``: ``{(vid, clip): [(s, e), ...]}`` frame intervals
    (:func:`truth_events_by_clip`); None scores against the rows' own
    chunk ``status_id`` (a top-k chunk hits when its status is an event
    status)."""
    ks = sorted(set(int(k) for k in ks))
    hits = {k: [] for k in ks}
    errors = []
    per_side: dict = {}
    scored = skipped_no_event = skipped_no_frames = 0

    for row in rows:
        topk = row.get("topk_chunks") or []
        if truth is not None:
            spans = truth.get((int(row["vid"]), int(row["clip"])))
            if not spans:
                skipped_no_event += 1
                continue
            if not any(c.get("start_frame") is not None
                       and c.get("end_frame") is not None for c in topk):
                skipped_no_frames += 1
                continue

            def is_hit(c):
                return (c.get("start_frame") is not None
                        and c.get("end_frame") is not None
                        and _overlaps(c["start_frame"], c["end_frame"],
                                      spans))

            err = _center_error(topk[0], spans) if topk else None
        else:
            statuses = [c.get("status_id") for c in topk]
            if all(s is None for s in statuses):
                skipped_no_event += 1
                continue
            # an event-bearing clip has an event chunk in its sequence
            seq_statuses = row.get("status_ids") or statuses
            if not any(s in EVENT_STATUS_IDS for s in seq_statuses
                       if s is not None):
                skipped_no_event += 1
                continue

            def is_hit(c):
                return c.get("status_id") in EVENT_STATUS_IDS

            err = None

        scored += 1
        side_bucket = per_side.setdefault(
            str(row.get("side")), {k: [] for k in ks})
        for k in ks:
            hit = any(is_hit(c) for c in topk[:k])
            hits[k].append(hit)
            side_bucket[k].append(hit)
        if err is not None:
            errors.append(err)

    result = {
        "clips_scored": scored,
        "clips_without_events": skipped_no_event,
        "clips_without_frame_numbers": skipped_no_frames,
        "ground_truth": "template" if truth is not None else "status_id",
        "hit_at": {str(k): (float(np.mean(v)) if v else None)
                   for k, v in hits.items()},
        "per_side_hit_at": {
            side: {str(k): (float(np.mean(v)) if v else None)
                   for k, v in b.items()}
            for side, b in per_side.items()},
    }
    if errors:
        result["center_error_mean"] = float(np.mean(errors))
        result["center_error_median"] = float(np.median(errors))
    return result
