"""Auto-calibration of the kNN+HMM segmentation hyperparameters.

Port of vit_research_tpu/segment/tune.py: the one top-k at ``max(ks)``
and the Viterbi decodes run on the caller's ``device``; the sweep is the
reference's host numpy.

The reference hand-tuned every constant in its segmentation stack — the
HMM transition matrix (reference: nba_proj/hmm.py:10), the kNN vote/
confidence thresholds (reference: nba_proj/generate_clips_hmm.py:58,262,
nba_proj/chroma.py:62, nba_proj/generate_clips.py:165) and the streak/
padding rules (reference: nba_proj/generate_clips_hmm.py:155-165) — and
those numbers are calibrated to ONE specific random-ViT feature space
(SURVEY.md §7 "hard parts"). Re-seeding the backbone, changing the
embedder, or moving to new footage silently invalidates them.

This module turns that recalibration into one sweep:

- the expensive stage (device top-k) runs ONCE at ``max(ks)`` — exact
  top-k is sorted by score, so the first ``k`` columns ARE the k-NN
  result for every smaller ``k`` in the grid;
- everything downstream (confidence fusion, Viterbi decode, clip
  extraction, scoring) is cheap vectorized host work swept over the
  full cartesian grid;
- ground truth comes from the same ``manual_intervals.csv`` the
  reference labeled by hand.

Scores: frame-level accuracy of the decoded state path, and clip-level
precision/recall/F1 with greedy same-side IoU matching. A separate
helper picks the write-back confidence threshold as the smallest value
meeting a target precision against the truth labels (the reference
guessed 0.7 and 0.85 for its two loops).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from vit_research_tpu_torch.segment import knn as knn_mod
from vit_research_tpu_torch.segment.clips import (
    ClipInterval, clip_intervals_from_decoded, decoded_runs)
from vit_research_tpu_torch.segment.hmm import (DEFAULT_TRANSITIONS, STATES,
                                                smooth_probabilities)

# left <-> right jumps are structurally impossible in broadcast footage
# (play direction can't flip without a 'none' interlude); the fitter
# keeps these zeros by default like the reference's matrix.
STRUCTURAL_ZEROS = ((0, 1), (1, 0))


def fit_transition_matrix(state_seqs, *, smoothing: float = 1.0,
                          structural_zeros=STRUCTURAL_ZEROS) -> np.ndarray:
    """Estimate a 3-state transition matrix by transition counting.

    Args:
      state_seqs: iterable of int sequences over {0,1,2} (-1 entries are
        ignore markers: transitions into/out of them are skipped).
      smoothing: Laplace count added to every permitted cell so unseen
        but legal transitions keep nonzero mass.
      structural_zeros: (from, to) cells pinned to exactly 0 (forbidden
        transitions stay forbidden no matter the data — the reference's
        matrix forbids direct left<->right, nba_proj/hmm.py:10).

    Returns a row-stochastic (3, 3) float32 matrix.
    """
    counts = np.zeros((3, 3), dtype=np.float64)
    for seq in state_seqs:
        seq = np.asarray(seq)
        for a, b in zip(seq[:-1], seq[1:]):
            if a < 0 or b < 0:
                continue
            counts[int(a), int(b)] += 1.0
    counts += float(smoothing)
    for a, b in structural_zeros or ():
        counts[a, b] = 0.0
    rows = counts.sum(axis=1, keepdims=True)
    rows[rows == 0.0] = 1.0
    return (counts / rows).astype(np.float32)


def truth_states(manual, frame_names) -> np.ndarray:
    """(N,) int truth states for ordered frames: 0/1/2, -1 unlabeled."""
    return np.asarray(manual.label_array(list(frame_names)), np.int64)


def truth_intervals(states, sides=("left", "right")) -> list[ClipInterval]:
    """Ground-truth possession intervals: maximal same-side runs of the
    truth state array (unlabeled frames break runs)."""
    decoded = [STATES[s] if s >= 0 else "?" for s in np.asarray(states)]
    return [r for r in decoded_runs(decoded) if r.side in sides]


def _iou(a: ClipInterval, b: ClipInterval) -> float:
    inter = min(a.end, b.end) - max(a.start, b.start) + 1
    if inter <= 0:
        return 0.0
    union = (a.end - a.start + 1) + (b.end - b.start + 1) - inter
    return inter / union


def interval_prf(pred, true, *, iou: float = 0.5) -> dict:
    """Greedy same-side IoU matching -> precision/recall/F1.

    Each truth interval is matched to at most one prediction (best IoU
    first), so duplicated detections count as false positives.
    """
    pairs = sorted(
        ((_iou(p, t), i, j) for i, p in enumerate(pred)
         for j, t in enumerate(true) if p.side == t.side),
        key=lambda x: -x[0])
    used_p: set = set()
    used_t: set = set()
    matched = 0
    for score, i, j in pairs:
        if score < iou:
            break
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        matched += 1
    precision = matched / len(pred) if pred else (1.0 if not true else 0.0)
    recall = matched / len(true) if true else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "matched": matched, "n_pred": len(pred), "n_true": len(true)}


def writeback_threshold(emissions, decision, truth, *,
                        target_precision: float = 0.99,
                        grid=None) -> dict:
    """Smallest confidence threshold whose write-back would be at least
    ``target_precision`` correct against the truth labels.

    The write-back gate is ``mean stored prob of the decided class >=
    threshold`` (segment/knn.py::fused_confidence); the reference picked
    0.7 / 0.85 by eye. Returns ``{'threshold', 'precision', 'coverage'}``.
    When no grid value reaches the target, ``threshold`` is None and
    ``precision``/``coverage`` report the BEST precision actually
    observed (and the grid value achieving it under ``best_threshold``)
    so the operator can judge whether to lower the target.
    """
    emissions = np.asarray(emissions)
    decision = np.asarray(decision)
    truth = np.asarray(truth)
    conf = np.take_along_axis(emissions, decision[:, None], axis=1)[:, 0]
    labeled = truth >= 0
    grid = np.asarray(sorted(grid if grid is not None
                             else np.round(np.arange(0.50, 1.0, 0.05), 2)))
    best = {"threshold": None, "best_threshold": None,
            "precision": 0.0, "coverage": 0.0}
    for th in grid:
        sel = labeled & (conf >= th)
        if not sel.any():
            continue
        prec = float((decision[sel] == truth[sel]).mean())
        cov = float(sel.sum() / max(labeled.sum(), 1))
        if prec >= target_precision:
            return {"threshold": float(th), "precision": prec,
                    "coverage": cov}
        if prec > best["precision"]:
            best.update(best_threshold=float(th), precision=prec,
                        coverage=cov)
    return best


@dataclasses.dataclass
class TuneResult:
    params: dict       # k, transitions (name), min_len, pad
    frame_accuracy: float
    precision: float
    recall: float
    f1: float
    n_pred: int
    n_true: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def tune_knn_hmm(frame_names, embeddings, corpus, manual, *, device,
                 ks=(5, 10, 25, 50), min_lens=(50, 100, 150),
                 pads=(0, 50, 100), transition_candidates=None,
                 fit_transitions: bool = True, metric: str = "l2",
                 iou: float = 0.5):
    """Sweep the kNN+HMM segmentation grid against manual intervals.

    Args:
      frame_names/embeddings: one video's ordered frames + embeddings
        (embed ONCE with the production engine; this function never
        re-embeds).
      corpus: labeled corpus dict (segment/knn.py::corpus_from_collection).
      manual: data.labels.ManualIntervals ground truth for these frames.
      device: where the top-k and the Viterbi decodes run.
      transition_candidates: optional {name: (3,3) matrix} to sweep; the
        reference default is always included, and a counting fit from the
        truth states is added when ``fit_transitions``.

    Returns (results sorted best-first by (f1, frame_accuracy),
    transitions actually swept as {name: matrix}, knn arrays at
    ``max(ks)`` as ``{'neighbor_labels': (N, k_max), 'neighbor_probs':
    (N, k_max, 3)}`` — the k-prefix slice of these IS the kNN result at
    any smaller k, so callers never need a second device top-k).
    """
    # clamp oversized ks to the corpus size instead of dropping them
    ks = sorted({min(int(k), len(corpus["labels"])) for k in ks})
    if not ks or not list(min_lens) or not list(pads):
        raise ValueError("empty parameter grid: ks/min_lens/pads must "
                         "each have at least one value")
    k_max = max(ks)
    truth = truth_states(manual, frame_names)
    true_iv = truth_intervals(truth)
    labeled = truth >= 0

    trans = {"reference": DEFAULT_TRANSITIONS}
    if fit_transitions and (truth >= 0).sum() >= 2:
        trans["fitted"] = fit_transition_matrix([truth])
    for name, m in (transition_candidates or {}).items():
        trans[name] = np.asarray(m, np.float32)

    # one device top-k at k_max; every smaller k is a prefix slice
    nl, idx, _ = knn_mod.knn_labels(
        embeddings, corpus["embeddings"], corpus["labels"], k_max,
        device=device, metric=metric)
    nl = np.asarray(nl)
    all_probs = np.asarray(corpus["probs"])[np.asarray(idx)]

    results = []
    for k in ks:
        fused = knn_mod.fused_confidence(nl[:, :k], all_probs[:, :k],
                                         top_n=k)
        for tname, tmat in trans.items():
            path = smooth_probabilities(fused["emissions"],
                                        transition_matrix=tmat, device=device)
            acc = (float((path[labeled] == truth[labeled]).mean())
                   if labeled.any() else 0.0)
            decoded = [STATES[i] for i in path]
            for min_len, pad in itertools.product(min_lens, pads):
                pred = clip_intervals_from_decoded(
                    decoded, min_len=int(min_len), pad=int(pad))
                prf = interval_prf(pred, true_iv, iou=iou)
                results.append(TuneResult(
                    params={"k": k, "transitions": tname,
                            "min_len": int(min_len), "pad": int(pad)},
                    frame_accuracy=acc, precision=prf["precision"],
                    recall=prf["recall"], f1=prf["f1"],
                    n_pred=prf["n_pred"], n_true=prf["n_true"]))
    results.sort(key=lambda r: (-r.f1, -r.frame_accuracy,
                                r.params["k"], r.params["min_len"]))
    return results, trans, {"neighbor_labels": nl,
                            "neighbor_probs": all_probs}
