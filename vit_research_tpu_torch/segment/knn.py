"""kNN vote classification for possession-side labelling.

Port of vit_research_tpu/segment/knn.py (that module cannot be imported
here: its package imports JAX): the two-pass self-labelling
(nba_proj/chroma.py:36-134) and the streaming fused confidence
(nba_proj/generate_clips_hmm.py:179-310). Neighbour search is one masked
matmul + top-k on the device (ops/topk.py); the vote arithmetic is the
reference's numpy, carried over unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.ops.topk import l2_normalize, masked_topk

SIDES = ("left", "right", "none")


def corpus_from_collection(col) -> dict:
    """Read a labelled frame collection (write-frame-db / write-backs) into
    the kNN corpus dict ``{'embeddings' (M, D), 'labels' (M,) int ids,
    'probs' (M, 3)}``. Raises ValueError for empty or unlabelled
    collections."""
    got = col.get(include=("embeddings", "metadatas"))
    if not got["ids"]:
        raise ValueError(f"collection {col.name!r} is empty — build it "
                         "with write-frame-db first")
    labels, probs = [], []
    for m in got["metadatas"]:
        label = m.get("label")
        if label is None:
            raise ValueError(
                f"collection {col.name!r} rows carry no 'label' metadata "
                "— not a labeled frame collection (frame RAG collections "
                "store side/t_norm only; build a corpus with "
                "write-frame-db)")
        label = str(label)
        if label not in SIDES:
            raise ValueError(f"collection {col.name!r} has non-side label "
                             f"{label!r}; not a labeled frame collection")
        labels.append(SIDES.index(label))
        probs.append([float(m.get(f"{s}_prob", 0.0)) for s in SIDES])
    return {"embeddings": np.asarray(got["embeddings"], np.float32),
            "labels": np.asarray(labels, np.int64),
            "probs": np.asarray(probs, np.float32)}


def temp_softmax(x, temperature: float = 1.0) -> np.ndarray:
    x = np.asarray(x, np.float64) / temperature
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _on(x, dev) -> torch.Tensor:
    """Rows as a float32 tensor on ``dev`` (no copy for one already
    there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def knn_labels(query_embs, corpus_embs, corpus_labels, k: int, *, device,
               metric: str = "l2", mask=None):
    """Batched k-NN on ``device``: returns (neighbour label ids (Q, k),
    neighbour indices (Q, k), valid (Q, k)) as numpy, label -1 where a
    neighbour was masked out. ``corpus_labels``: (N,) ints, 0=left,
    1=right, 2=none. ``metric='cosine'`` L2-normalises both sides. Query
    and corpus rows may be numpy arrays or tensors already on ``device``."""
    dev = resolve_device(device)
    q = _on(query_embs, dev)
    c = _on(corpus_embs, dev)
    if metric == "cosine":
        q, c = l2_normalize(q), l2_normalize(c)
    scores, idx = masked_topk(q, c, mask, k=k, metric=metric)
    idx = idx.cpu().numpy()
    valid = scores.cpu().numpy() > -1e29
    labels = np.where(valid, np.asarray(corpus_labels)[idx], -1)
    return labels, idx, valid


def vote_counts(neighbor_labels) -> np.ndarray:
    """(Q, k) label ids -> (Q, 3) votes (ignores -1 padding)."""
    return np.stack([(neighbor_labels == c).sum(axis=1) for c in range(3)],
                    axis=1)


def classify_pass1(neighbor_labels, min_votes: int = 20,
                   temperature: float = 7.0):
    """Pass-1 decision per query: side index or -1 (defer to pass 2),
    plus temperature-softmax probs (reference: nba_proj/chroma.py:36-71)."""
    counts = vote_counts(neighbor_labels)
    winner = counts.argmax(axis=1)
    accept = counts.max(axis=1) >= min_votes
    decision = np.where(accept, winner, -1)
    return decision, temp_softmax(counts, temperature)


def classify_pass2(neighbor_labels, temperature: float = 7.0):
    """Pass-2: plain argmax (reference: nba_proj/chroma.py:102-134)."""
    counts = vote_counts(neighbor_labels)
    return counts.argmax(axis=1), temp_softmax(counts, temperature)


def fused_confidence(neighbor_labels, neighbor_probs, *, top_n: int,
                     confidence_threshold: float = 0.7):
    """Streaming-classifier confidence fusion
    (reference: nba_proj/generate_clips_hmm.py:179-310).

    Args:
      neighbor_labels: (Q, k) label ids (-1 = padding).
      neighbor_probs: (Q, k, 3) stored per-neighbour probabilities.
      top_n: the k used for the unanimity check.
    Returns dict with 'emissions' (Q, 3) mean stored probabilities (the
    HMM emissions), 'fused' (Q, 3) = (vote fraction + mean prob) / 2,
    'decision' (Q,) argmax of fused, 'confident' (Q,) mean prob of the
    decision >= threshold, 'upsert_probs' (Q, 3) (0.999998 one-hot when
    the vote is unanimous, else the class means)."""
    q, k = neighbor_labels.shape
    valid = (neighbor_labels >= 0)[..., None].astype(np.float64)
    denom = np.maximum(valid.sum(axis=1), 1.0)
    mean_probs = (np.asarray(neighbor_probs, np.float64) * valid).sum(axis=1) \
        / denom
    counts = vote_counts(neighbor_labels).astype(np.float64)
    frac = counts / max(k, 1)
    fused = (mean_probs + frac) / 2.0
    decision = fused.argmax(axis=1)

    dec_mean = np.take_along_axis(mean_probs, decision[:, None], axis=1)[:, 0]
    confident = dec_mean >= confidence_threshold
    unanimous = np.take_along_axis(counts, decision[:, None], axis=1)[:, 0] \
        == top_n
    one_hot = np.full((q, 3), 1e-6)
    np.put_along_axis(one_hot, decision[:, None], 0.999998, axis=1)
    upsert_probs = np.where(unanimous[:, None], one_hot, mean_probs)
    return {
        "emissions": mean_probs,
        "fused": fused,
        "decision": decision,
        "confident": confident,
        "upsert_probs": upsert_probs,
    }


def two_pass_self_label(query_embs, corpus_embs, corpus_labels, *, device,
                        k: int = 25, min_votes: int = 20,
                        temperature: float = 7.0, metric: str = "l2"):
    """Two-pass self-labelling of a frame set on ``device``.

    Pass 1 labels the frames with at least ``min_votes`` of ``k`` agreeing
    neighbours against the seed corpus; the accepted frames join the
    corpus (the reference's upsert-back, nba_proj/chroma.py:257-309) and
    pass 2 labels the rest against the enlarged corpus by plain argmax.
    The queries go to the card once, and the enlarged corpus is built
    there from the seed rows and the accepted queries.

    Returns (labels (Q,), probs (Q, 3), accepted_pass1 (Q,) bool)."""
    dev = resolve_device(device)
    q = _on(query_embs, dev)
    corpus = _on(corpus_embs, dev)
    nl, _, _ = knn_labels(q, corpus, corpus_labels, k, device=dev,
                          metric=metric)
    decision, probs = classify_pass1(nl, min_votes, temperature)
    accepted = decision >= 0

    out_labels = decision.copy()
    out_probs = probs.copy()
    deferred = ~accepted
    if deferred.any():
        acc = torch.from_numpy(np.nonzero(accepted)[0]).to(dev)
        big_corpus = torch.cat([corpus, q[acc]], dim=0)
        big_labels = np.concatenate(
            [np.asarray(corpus_labels), decision[accepted]], axis=0)
        later = torch.from_numpy(np.nonzero(deferred)[0]).to(dev)
        nl2, _, _ = knn_labels(q[later], big_corpus, big_labels, k,
                               device=dev, metric=metric)
        d2, p2 = classify_pass2(nl2, temperature)
        out_labels[deferred] = d2
        out_probs[deferred] = p2
    return out_labels, out_probs, accepted
