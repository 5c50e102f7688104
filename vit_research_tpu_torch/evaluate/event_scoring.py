"""Event spans of an event template, for the strided-embedding check.

The part of vit_research_tpu/evaluate/event_scoring.py that ``segment
--event-template`` needs: the shortest labelled event, with the
reference's make/miss-minus-none semantics (later categories overwrite
earlier ones: make -> miss -> none, data/labels.py::frame_event_status).
The scoring functions (hit@k, centre error) come with the evaluation
verbs.
"""

from __future__ import annotations


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
