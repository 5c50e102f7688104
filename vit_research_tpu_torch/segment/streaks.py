"""Sliding-window streak detection with flagged re-checks.

Port of vit_research_tpu/segment/streaks.py (host numpy, unchanged).
Equivalent of the reference's pre-HMM streaming classifier
(reference: nba_proj/generate_clips.py:241-340): decisions accumulate in
a sliding window; a window dominated by one side opens/extends a clip
interval, low-confidence frames are flagged and re-checked against the
window majority, and interval boundaries land where the dominant side
changes. The HMM pipeline (segment/pipeline.py) superseded this; it is
kept for capability parity and as a cheap baseline.
"""

from __future__ import annotations

import numpy as np


def streak_intervals(decisions, confidences, *, window: int = 50,
                     dominance: float = 0.8, conf_threshold: float = 0.7,
                     min_len: int = 50) -> list[tuple]:
    """Args:
      decisions: (T,) int side ids per frame (0 left, 1 right, 2 none).
      confidences: (T,) decision confidences; low ones defer to the
        window majority (the reference's flagged-index re-checks).
    Returns list of (side_id, start, end) inclusive intervals."""
    decisions = np.asarray(decisions).copy()
    confidences = np.asarray(confidences)
    t = len(decisions)

    # Re-check low-confidence frames against their window's majority.
    for i in range(t):
        if confidences[i] >= conf_threshold:
            continue
        lo, hi = max(0, i - window // 2), min(t, i + window // 2 + 1)
        votes = decisions[lo:hi][confidences[lo:hi] >= conf_threshold]
        if len(votes):
            decisions[i] = np.bincount(votes, minlength=3).argmax()

    intervals = []
    start = 0
    for i in range(1, t + 1):
        if i == t or decisions[i] != decisions[start]:
            side = int(decisions[start])
            length = i - start
            if side in (0, 1) and length >= min_len:
                # Runs are pure by construction (the loop splits at every
                # decision change), so any within-run purity test is
                # vacuous. What the +-window/2 neighborhood CAN tell us
                # is whether the run borders a contested region: reject
                # when the OPPOSITE side occupies more than
                # (1 - dominance) of the margins (the reference's
                # window-majority gate suppressed exactly these streaks
                # in flickering left/right regions; 'none' margins are
                # fine — every clean possession borders 'none').
                lo = max(0, start - window // 2)
                hi = min(t, i + window // 2)
                margins = np.concatenate(
                    [decisions[lo:start], decisions[i:hi]])
                other = 1 - side
                contested = (np.mean(margins == other) if len(margins)
                             else 0.0)
                if contested <= 1.0 - dominance:
                    intervals.append((side, start, i - 1))
            start = i
    return intervals
