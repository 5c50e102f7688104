"""Soft change-point scoring over signed logit series.

Port of vit_research_tpu/segment/changepoint.py (the working version of
the reference's scratchpad, nba_proj/testing_clip_boundary_algos.py:9-41):
for every position, compare proximity-weighted means of the signed logits
before and after it; a high absolute difference marks a soft clip
boundary. Host numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np


def proximity_weights(window: int, decay: float = 0.5) -> np.ndarray:
    """Weights favoring positions near the split point."""
    w = decay ** np.arange(window, dtype=np.float64)
    return w / w.sum()


def changepoint_scores(signed_logits, *, window: int = 25,
                       decay: float = 0.9) -> np.ndarray:
    """(T,) signed series -> (T,) soft boundary scores.

    score[t] = |weighted_mean(x[t-window:t]) - weighted_mean(x[t:t+window])|
    with proximity weights decaying away from t. Edges score 0."""
    x = np.asarray(signed_logits, np.float64)
    t = len(x)
    w = proximity_weights(window, decay)
    scores = np.zeros(t)
    for i in range(window, t - window):
        before = x[i - window:i][::-1]  # nearest-first
        after = x[i:i + window]
        scores[i] = abs(before @ w - after @ w)
    return scores


def detect_changepoints(signed_logits, *, window: int = 25,
                        decay: float = 0.9, threshold: float | None = None,
                        min_separation: int = 50) -> np.ndarray:
    """Local maxima of the score above a threshold, greedily separated."""
    scores = changepoint_scores(signed_logits, window=window, decay=decay)
    if threshold is None:
        threshold = scores.mean() + 2 * scores.std()
    order = np.argsort(-scores)
    picked = []
    for i in order:
        if scores[i] < threshold:
            break
        if all(abs(i - j) >= min_separation for j in picked):
            picked.append(int(i))
    return np.asarray(sorted(picked), np.int64)
